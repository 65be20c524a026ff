"""The plain reference of the benchmark's two configurations.

Show, Attend and Tell (Xu et al. 2015, arXiv:1502.03044) as the
yvokeller/Show-Attend-and-Tell experiments train and decode it, written
from the paper's and that repository's equations in plain PyTorch: no
kernel, no cache, no CUDA graph, nothing of the program under test. It
reads the weights in the harness's dict (satbench/weights.py), whose names
are the reference repository's module names.

  encoder   VGG19's 16 3x3 convolutions with ReLU and its first four max
            pools, NHWC images in, a (B, L, D) annotation grid out
  attention e_l = v . tanh(W a_l + U h) + b_v, alpha = softmax(e),
            z = sum_l alpha_l a_l
  step      gate = sigmoid(f_beta h), LSTM cell on [E y, gate * z], and
            the advanced deep output relu(f_out(relu(f_h h') +
            relu(f_z z) + E y)), whose logits the reference relus too
  beam      the reference's flat beam: raw summed logits, row 0 alone
            expanded at step 1, the top K of the (B, K*V) candidates by
            value and then lower flat index, completion on the stop ids,
            the first-encountered best completed sentence, at most 51
            steps, finished images frozen
  training  teacher forcing, dropout on h before the head, the packed
            cross-entropy over the first T - 1 steps, the doubly
            stochastic regulariser, and Adam (torch.optim.Adam's update)

Every function computes in float32. `precision(tf32)` sets whether matrix
products and convolutions may use TF32: the comparison's control runs this
reference with TF32 on, the step below float32 that tempts a faster path.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

# VGG19's feature layout: output channels of each conv, "M" a 2x2 max pool.
# The fifth pool is left out, so a 224-px image gives a 14 x 14 grid.
VGG19_CONVS = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512)


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in TF32 (`tf32`) or float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def vgg19_conv_names():
    """(name, out channels) of each conv, torchvision's feature indices."""
    out, idx = [], 0
    for entry in VGG19_CONVS:
        if entry != "M":
            out.append((f"features.{idx}", entry))
            idx += 2
        else:
            idx += 1
    return out


def encode(w: dict, images: torch.Tensor, block: int = 32) -> torch.Tensor:
    """images (B, S, S, 3) -> grid (B, L, 512), `block` images at a time."""
    grids = []
    for s in range(0, images.shape[0], block):
        x = images[s:s + block].float().permute(0, 3, 1, 2)
        convs = iter(vgg19_conv_names())
        for entry in VGG19_CONVS:
            if entry == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                name, _ = next(convs)
                x = F.relu(F.conv2d(x, w[f"{name}.weight"],
                                    w[f"{name}.bias"], padding=1))
        grids.append(x.flatten(2).transpose(1, 2))
    return torch.cat(grids).contiguous()


def linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ w[f"{name}.weight"].t() + w[f"{name}.bias"]


def initial_state(w: dict, grid: torch.Tensor):
    mean = grid.mean(dim=1)
    return torch.tanh(linear(w, "init_h", mean)), torch.tanh(
        linear(w, "init_c", mean))


def attend(w: dict, grid, keys, h, rows_per_image: int = 1):
    """(context, alpha) for hidden rows h (B*R, E) over grid (B, L, D)."""
    B, L, D = grid.shape
    R = rows_per_image
    u = linear(w, "attention.U", h).view(B, R, 1, -1)
    t = torch.tanh(keys[:, None] + u)                       # (B, R, L, E)
    e = t @ w["attention.v.weight"][0] + w["attention.v.bias"][0]
    alpha = torch.softmax(e, dim=-1)                        # (B, R, L)
    context = alpha @ grid                                  # (B, R, D)
    return context.reshape(B * R, D), alpha.reshape(B * R, L)


def lstm(w: dict, x, h, c):
    gates = (x @ w["lstm.weight_ih"].t() + w["lstm.bias_ih"]
             + h @ w["lstm.weight_hh"].t() + w["lstm.bias_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def recur(w: dict, grid, keys, h, c, emb, rows_per_image: int = 1):
    """Attention, gate and LSTM cell: (h', c', alpha, context)."""
    context, alpha = attend(w, grid, keys, h, rows_per_image)
    gated = torch.sigmoid(linear(w, "f_beta", h)) * context
    h, c = lstm(w, torch.cat([emb, gated], dim=-1), h, c)
    return h, c, alpha, context


def head(w: dict, h, context, emb):
    """The advanced deep output, relu'd logits."""
    x = (F.relu(linear(w, "f_h", h)) + F.relu(linear(w, "f_z", context))
         + emb)
    return F.relu(linear(w, "f_out", x))


def step(w: dict, grid, keys, h, c, prev, rows_per_image: int = 1):
    """One decode step from tokens `prev`: (h', c', logits, alpha)."""
    emb = w["embedding.weight"][prev]
    h, c, alpha, context = recur(w, grid, keys, h, c, emb, rows_per_image)
    return h, c, head(w, h, context, emb), alpha


@torch.no_grad()
def beam_search(w: dict, grid, beam: int, stop_ids, start: int,
                max_steps: int = 51) -> dict:
    """The reference's flat beam over each image of grid (B, L, D):
    tokens (B, 1 + max_steps), length, score, found, alphas (B, 1 +
    max_steps, L), in the layout of the caption step's result, and the
    number of steps run (fewer than max_steps when every image has
    completed all its beams)."""
    B, L, _ = grid.shape
    K, dev = beam, grid.device
    T = 1 + max_steps
    keys = linear(w, "attention.W", grid)
    h, c = (x.repeat_interleave(K, dim=0) for x in initial_state(w, grid))
    rows = torch.arange(B, device=dev)
    ranks = torch.arange(K, device=dev)
    scores = torch.zeros(B, K, device=dev)
    prev = torch.full((B, K), start, dtype=torch.long, device=dev)
    live = (ranks == 0).expand(B, K).clone()
    live_count = torch.full((B,), K, dtype=torch.long, device=dev)
    best_score = torch.full((B,), -math.inf, device=dev)
    best_len = torch.zeros(B, dtype=torch.long, device=dev)
    best_rank = torch.zeros(B, dtype=torch.long, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    words = torch.zeros(B, T, K, dtype=torch.long, device=dev)
    parents = torch.zeros(B, T, K, dtype=torch.long, device=dev)
    alpha_steps = torch.zeros(B, T, K, L, device=dev)
    stop_a, stop_b = stop_ids
    ran = 0
    for t in range(1, T):
        active = live_count > 0
        if not bool(active.any()):
            break
        ran = t
        h2, c2, logits, alpha = step(w, grid, keys, h, c, prev.view(-1), K)
        V = logits.shape[-1]
        cand = (scores[..., None] + logits.view(B, K, V)).masked_fill(
            ~live[..., None], -math.inf).view(B, K * V)
        # value descending, then lower flat index first
        values, flat = torch.sort(cand, dim=1, descending=True, stable=True)
        values, flat = values[:, :K], flat[:, :K]
        parent, word = flat // V, flat % V
        valid = ranks[None] < live_count[:, None]
        is_stop = (word == stop_a) | (word == stop_b)
        completed = valid & is_stop
        comp = values.masked_fill(~completed, -math.inf)
        bi = comp.argmax(dim=1)
        step_best = comp[rows, bi]
        imp = active & (step_best > best_score)
        live_new = valid & ~is_stop & active[:, None]
        act = active[:, None]
        h = torch.where(act[..., None], h2.view(B, K, -1)[rows[:, None],
                                                          parent],
                        h.view(B, K, -1)).view(B * K, -1)
        c = torch.where(act[..., None], c2.view(B, K, -1)[rows[:, None],
                                                          parent],
                        c.view(B, K, -1)).view(B * K, -1)
        scores = torch.where(act, values.masked_fill(~live_new, -math.inf),
                             scores)
        prev = torch.where(act, word, prev)
        live = live_new
        found = found | (active & completed.any(dim=1))
        live_count = live_count - torch.where(active, completed.sum(dim=1),
                                              0)
        best_score = torch.where(imp, step_best, best_score)
        best_len = torch.where(imp, t, best_len)
        best_rank = torch.where(imp, bi, best_rank)
        words[:, t] = word
        parents[:, t] = parent
        alpha_steps[:, t] = alpha.view(B, K, L)
    tokens = torch.full((B, T), start, dtype=torch.long, device=dev)
    alphas = torch.zeros(B, T, L, device=dev)
    alphas[:, 0] = 1.0
    rank = best_rank
    for t in range(T - 1, 0, -1):
        on = t <= best_len
        tokens[:, t] = torch.where(on, words[rows, t, rank], start)
        par = parents[rows, t, rank]
        alphas[:, t] = torch.where(on[:, None], alpha_steps[rows, t, par],
                                   0.0)
        rank = torch.where(on, par, rank)
    tokens.masked_fill_(~found[:, None], 0)
    alphas.masked_fill_(~found[:, None, None], 0.0)
    return {"tokens": tokens, "length": best_len, "score": best_score,
            "found": found, "alphas": alphas, "steps": ran}


@torch.no_grad()
def replay(w: dict, grid, tokens, length):
    """Teacher-force each image's token row along its own caption: (score,
    alphas) where score sums the logit of token t at step t, t = 1..length,
    and alphas (B, T, L) holds each step's attention (row 0 all ones, rows
    past the length zero), as the beam reports a found sentence."""
    B, T = tokens.shape
    L = grid.shape[1]
    keys = linear(w, "attention.W", grid)
    h, c = initial_state(w, grid)
    rows = torch.arange(B, device=grid.device)
    score = torch.zeros(B, device=grid.device)
    alphas = torch.zeros(B, T, L, device=grid.device)
    alphas[:, 0] = 1.0
    for t in range(1, int(length.max()) + 1):
        h, c, logits, alpha = step(w, grid, keys, h, c, tokens[:, t - 1])
        on = t <= length
        score = score + torch.where(on, logits[rows, tokens[:, t]], 0.0)
        alphas[:, t] = torch.where(on[:, None], alpha, 0.0)
    return score, alphas


def train_loss(w: dict, feats, captions, keep, dropout_rate: float,
               alpha_c: float):
    """Teacher-forced loss of one batch: feats (B, L, D), captions (B, T+1)
    int, keep (B, T, E) bool (None: no dropout). The cross-entropy keeps
    every target, padding included, and drops each row's last step; the
    regulariser is alpha_c * mean((1 - sum_t alpha)^2)."""
    captions = captions.long()
    T = captions.shape[1] - 1
    keys = linear(w, "attention.W", feats)
    h, c = initial_state(w, feats)
    embs = w["embedding.weight"][captions[:, :T]]
    hs, ctxs, alphas = [], [], []
    for t in range(T):
        h, c, alpha, context = recur(w, feats, keys, h, c, embs[:, t])
        hs.append(h)
        ctxs.append(context)
        alphas.append(alpha)
    hs = torch.stack(hs, dim=1)
    if keep is not None:
        hs = torch.where(keep, hs / (1.0 - dropout_rate), 0.0)
    logits = head(w, hs, torch.stack(ctxs, dim=1), embs)
    targets = captions[:, 1:]
    ce = F.cross_entropy(logits[:, :T - 1].reshape(-1, logits.shape[-1]),
                         targets[:, :T - 1].reshape(-1))
    reg = alpha_c * ((1.0 - torch.stack(alphas, dim=1).sum(dim=1)) ** 2
                     ).mean()
    return ce + reg


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8, no weight
    decay) over a dict of tensors."""

    def __init__(self, params: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def train_steps(w: dict, trainable, batches, dropout_rate: float,
                alpha_c: float, lr: float):
    """Adam steps from the weights `w` (not changed) over `batches`, a list
    of (feats, captions, keep): (losses, the first step's gradients,
    the parameters after the last step), the latter two over `trainable`
    names; a gradient that autograd leaves out is None."""
    params = {k: w[k].detach().clone().requires_grad_(True)
              for k in trainable}
    adam = Adam(params)
    losses, first = [], None
    for feats, captions, keep in batches:
        cur = dict(w) | params
        loss = train_loss(cur, feats, captions, keep, dropout_rate, alpha_c)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = dict(zip(params, grads))
        if first is None:
            first = {k: None if g is None else g.detach().clone()
                     for k, g in grads.items()}
        adam.step(params, grads, lr)
        losses.append(float(loss.detach()))
    return losses, first, {k: p.detach() for k, p in params.items()}
