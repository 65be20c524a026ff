"""The caption step: images -> encoder -> batched beam, greedy or sampled
decode.

Port of sat_tpu/engine/serving.py::build_caption_step. The step takes the
encoder and decoder modules as arguments, as sat_tpu's takes params: a
server moves them to the device once and passes them on every call. On the
card the decode replays CUDA graphs (models/beam.py), which the step keeps
in a GraphCache of its own, captured per batch shape and decoder: a
server's step lives as long as the server. `bf16=True` is sat_tpu's bf16
decode: the encoder runs in bf16 (its grid comes back f32) for beam and
greedy alike, and the beam stores its grid and keys in bf16, while greedy
decodes in f32, as sat_tpu's does. `decode="sample"` is sat_tpu's
sample decode (temperature, top-k, top-p, checked when the step is
built); its step takes a `torch.Generator` on the device, from which the
batch's Gumbel noise is drawn (models/beam.py::sample_caption), and, like
greedy, it decodes from the f32 grid. `fast_topk` and `pallas_topk` select
the beam's top-k route (models/beam.py).

Mesh serving (`mesh_data=N`, sat_tpu's data-parallel serving): the batch is
padded to a multiple of N by repeating its last row and split into N
contiguous slices (parallel/mesh.py), and slice i runs on card i of the
mesh (`devices`, default every visible card) with its own copy of the
weights, made at the step's first call with those modules, and its own
captured graphs (a GraphCache a replica). One thread a replica launches
its slice, so every card starts before any is waited on; the results are
concatenated in order on `device` and cut to the batch. Images decode
independently, so the tokens are the one-device step's; on the card the
matrix products may take another algorithm for another row count, so
scores and alphas may differ in their last bits. A sampled batch draws its
noise for the whole padded batch from the one generator on `device`, and
each slice decodes its rows of it: a batch whose size the mesh divides
draws what the one-device step draws.

AOT export (sat_tpu's `build_caption_fn`, `export_caption_artifact`,
`load_caption_artifact`): `build_caption_fn` is a module with the weights
baked in, whose decode is models/beam.py's static form (every step, no
host read, the loops as torch while_loops); `export_caption_artifact`
traces it with torch.export at one batch shape and writes a `.pt2` file
for one device (sat_tpu writes StableHLO). The attention middle is the
operator `sat::attention_fwd` in every artifact, and the beam's top-k the
library sort unless `pallas_topk=True` asks for `sat::topk`, as sat_tpu's
export defaults to `lax.top_k`. `load_caption_artifact`
(engine/artifact.py) needs torch and the operators, no model code.
"""

from __future__ import annotations

import contextlib
import copy
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sat_tpu_torch import constants
from sat_tpu_torch.device import resolve_device, use_f32_math
from sat_tpu_torch.engine.artifact import (  # noqa: F401  (sat_tpu's name)
    ARTIFACT_META, load_caption_artifact)
from sat_tpu_torch.models.beam import (BeamResult, beam_search_batched,
                                       beam_search_static, greedy_caption,
                                       greedy_caption_static, gumbel_noise_,
                                       sample_caption, use_kernel_topk,
                                       validate_sampling_params)
from sat_tpu_torch.models.decoder import DecoderConfig
from sat_tpu_torch.models.encoder import encoder_forward, encoder_grid
from sat_tpu_torch.parallel.mesh import make_mesh, pad_batch, slice_bounds
from sat_tpu_torch.utils import spans
from sat_tpu_torch.utils.graphs import GraphCache


def pack_scan(dcfg: DecoderConfig, tokens: torch.Tensor,
              lengths: torch.Tensor, alphas: torch.Tensor) -> dict:
    """greedy or sample output -> the beam result layout: the start token
    and its all-ones alpha row are prepended, so alphas row t belongs to
    tokens column t as in the beam layout; found is whether a stop id came
    within max_steps."""
    B, max_steps = tokens.shape
    start = torch.full((B, 1), dcfg.start_token, dtype=tokens.dtype,
                       device=tokens.device)
    ones = torch.ones((B, 1, alphas.shape[-1]), dtype=alphas.dtype,
                      device=alphas.device)
    return {"tokens": torch.cat([start, tokens], dim=1),
            "length": torch.clamp(lengths, max=max_steps - 1) + 1,
            "score": torch.zeros((B,), dtype=torch.float32,
                                 device=tokens.device),
            "found": lengths < max_steps,
            "alphas": torch.cat([ones, alphas], dim=1)}


def beam_outputs(res: BeamResult) -> dict:
    """A beam's result as the caption step's result dict."""
    return {"tokens": res.tokens, "length": res.length, "score": res.score,
            "found": res.found, "alphas": res.alphas}


def build_caption_step(network: str, dcfg: DecoderConfig, beam_size: int,
                       fast_topk: bool = False, bf16: bool = False,
                       decode: str = "beam", mesh_data: int = 1,
                       device="cuda", graphs: bool = True,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0, pallas_topk: bool | None = None,
                       devices=None):
    """step(encoder, decoder, images (B, S, S, 3)) -> result dict of
    tensors on `device`: tokens, length, score, found, alphas (the beam
    layout; greedy and sample are packed into it by `pack_scan`); for
    `decode="sample"`, step(encoder, decoder, images, generator). The
    modules must already be on `device`; images may be numpy or a tensor
    anywhere. `graphs=False` decodes eagerly on the card too. `step.graphs`
    is the step's GraphCache (None when eager; under a mesh, the list of
    the replicas'). `mesh_data` other than 1 (0: every card) serves over
    a mesh of `devices` (module note). Each call's encoder and decode are
    the spans `caption.encoder` and `caption.decode` (utils/spans.py),
    with device time."""
    if decode not in ("beam", "greedy", "sample"):
        raise ValueError(f"unknown decode mode {decode!r}")
    if decode == "sample":
        # fail when the step is built (a CLI's start), not at a request
        validate_sampling_params(temperature, top_k, top_p)
    use_kernel_topk(fast_topk, pallas_topk)
    dev = resolve_device(device)
    use_f32_math()
    mesh = (None if mesh_data == 1
            else [resolve_device(d) for d in make_mesh(mesh_data,
                                                       devices=devices)])

    def caption_on(d, cache, encoder, decoder, images, generator=None,
                   noise=None) -> dict:
        images = torch.as_tensor(images, dtype=torch.float32, device=d)
        with spans.span("caption.encoder", device=d):
            feats = encoder_forward(encoder, network, images,
                                    torch.bfloat16 if bf16 else None)
        with spans.span("caption.decode", device=d):
            if decode == "sample":
                return pack_scan(dcfg, *sample_caption(
                    decoder, feats, generator, temperature, top_k, top_p,
                    with_alphas=True, graphs=cache, noise=noise))
            if decode == "greedy":
                return pack_scan(dcfg, *greedy_caption(decoder, feats,
                                                       with_alphas=True,
                                                       graphs=cache))
            return beam_outputs(beam_search_batched(
                decoder, feats, beam_size, bf16=bf16, graphs=cache,
                fast_topk=fast_topk, pallas_topk=pallas_topk))

    if mesh is None:
        cache = GraphCache() if graphs and dev.type == "cuda" else None

        def caption(encoder, decoder, images, generator=None) -> dict:
            return caption_on(dev, cache, encoder, decoder, images,
                              generator)

        caption.graphs = cache
        return caption

    runner = MeshRunner(mesh, graphs)

    def caption(encoder, decoder, images, generator=None) -> dict:
        images = torch.as_tensor(images, dtype=torch.float32).cpu()
        noise = None
        if decode == "sample":
            noise = padded_noise(dcfg, len(images), len(mesh), dev,
                                 generator)

        def replica(i, d, cache, modules, rows, lo, hi):
            enc, dec = modules
            return caption_on(d, cache, enc, dec, rows, noise=None
                              if noise is None else noise[:, lo:hi])

        return runner.run(replica, images, (encoder, decoder), dev)

    caption.graphs = runner.graphs
    caption.mesh = mesh
    return caption


SAMPLE_NOT_EXPORTABLE = (
    "decode='sample' is not exportable as a single-input artifact (its "
    "step takes (images, generator)); use beam or greedy for AOT export, or "
    "serve sampling live via python -m sat_tpu_torch.serve --decode sample")


class CaptionProgram(torch.nn.Module):
    """images (B, S, S, 3) on the modules' device -> the result dict of
    `build_caption_step`, with the encoder's and the decoder's weights
    baked in: sat_tpu's `build_caption_fn`, the program that
    `export_caption_artifact` traces. The decode is the static form of
    models/beam.py (`beam_search_static`, `greedy_caption_static`): every
    step runs, with no host read, so the program has one control flow for
    every batch and gives the live step's results. The bf16 options are
    the caption step's. Live serving takes `build_caption_step`."""

    def __init__(self, network: str, dcfg: DecoderConfig,
                 encoder: torch.nn.Module, decoder: torch.nn.Module,
                 beam_size: int, fast_topk: bool = False, bf16: bool = False,
                 decode: str = "beam", pallas_topk: bool | None = None):
        super().__init__()
        if decode == "sample":
            raise ValueError(SAMPLE_NOT_EXPORTABLE)
        if decode not in ("beam", "greedy"):
            raise ValueError(f"unknown decode mode {decode!r}")
        use_kernel_topk(fast_topk, pallas_topk)
        self.encoder, self.decoder = encoder, decoder
        self.network, self.dcfg, self.beam_size = network, dcfg, beam_size
        self.fast_topk, self.bf16 = fast_topk, bf16
        self.decode, self.pallas_topk = decode, pallas_topk

    def forward(self, images: torch.Tensor) -> dict:
        feats = encoder_grid(self.encoder, self.network, images,
                             torch.bfloat16 if self.bf16 else None)
        if self.decode == "greedy":
            return pack_scan(self.dcfg, *greedy_caption_static(
                self.decoder, feats, with_alphas=True))
        return beam_outputs(beam_search_static(
            self.decoder, feats, self.beam_size, fast_topk=self.fast_topk,
            bf16=self.bf16, pallas_topk=self.pallas_topk))


def build_caption_fn(network: str, dcfg: DecoderConfig,
                     encoder: torch.nn.Module, decoder: torch.nn.Module,
                     beam_size: int, fast_topk: bool = False,
                     bf16: bool = False, decode: str = "beam",
                     pallas_topk: bool | None = None) -> CaptionProgram:
    """images -> result dict, the weights baked in (`CaptionProgram`): the
    form for AOT export. `decode="sample"` raises sat_tpu's ValueError."""
    return CaptionProgram(network, dcfg, encoder, decoder, beam_size,
                          fast_topk, bf16, decode, pallas_topk)


def export_caption_artifact(path: str, network: str, dcfg: DecoderConfig,
                            encoder: torch.nn.Module,
                            decoder: torch.nn.Module, batch_size: int,
                            image_size: int, beam_size: int,
                            fast_topk: bool = False, bf16: bool = False,
                            decode: str = "beam", pallas_topk: bool = False,
                            device="cuda") -> None:
    """Write the caption program for `batch_size` images of `image_size`
    pixels to `path`, a torch.export `.pt2` file that runs on `device`
    (sat_tpu's `platforms`), where the modules must already be. The
    defaults are sat_tpu's: `pallas_topk=False` exports the library top-k
    (the beam's sort route), `pallas_topk=True` the operator `sat::topk`;
    the attention middle is `sat::attention_fwd` either way. The program
    is traced under torch.no_grad at f32 math (TF32 off), as the live step
    runs. `decode="sample"` raises sat_tpu's ValueError."""
    dev = resolve_device(device)
    for name, module in (("encoder", encoder), ("decoder", decoder)):
        where = {p.device for p in module.parameters()}
        if any(d.type != dev.type or dev.index not in (None, d.index)
               for d in where):
            raise ValueError(f"the {name} is on {where}, not on {dev}: "
                             f"move it to the export device first")
    use_f32_math()
    program = build_caption_fn(network, dcfg, encoder, decoder, beam_size,
                               fast_topk=fast_topk, bf16=bf16, decode=decode,
                               pallas_topk=pallas_topk)
    images = torch.zeros((batch_size, image_size, image_size, 3),
                         device=dev)
    with torch.no_grad():
        exported = torch.export.export(program, (images,))
    exported.example_inputs = None     # not the batch of zeros in the file
    meta = {"network": network, "batch_size": batch_size,
            "image_size": image_size, "beam_size": beam_size,
            "decode": decode, "fast_topk": fast_topk, "bf16": bf16,
            "pallas_topk": pallas_topk, "device": str(dev)}
    torch.export.save(exported, path,
                      extra_files={ARTIFACT_META: json.dumps(meta)})


def padded_noise(dcfg: DecoderConfig, rows: int, cards: int, device,
                 generator) -> torch.Tensor:
    """A sampled batch's Gumbel noise (max_steps, padded rows, V) for the
    batch padded over `cards`, drawn as the one-device decode draws it."""
    padded = -(-rows // cards) * cards
    noise = torch.empty((constants.BEAM_MAX_STEPS, padded,
                         dcfg.effective_vocab_size), device=device)
    return gumbel_noise_(noise, generator)


class MeshRunner:
    """Data-parallel decode over the cards of a mesh: a copy of the modules
    on each card, made once per set of modules (the originals are kept, so
    that their ids stay theirs), a GraphCache each (`graphs`, None on the
    CPU or when eager), and a thread each. `run` pads a batch to a multiple
    of the cards by repeating its last row, has each thread run
    `fn(i, device, graph_cache, modules, rows, lo, hi)` on its slice
    [lo, hi) of the padded batch, waits for every card, and returns the
    slices' outputs (a tensor, or a tuple or dict of tensors) concatenated
    in order on `out`, cut to the batch."""

    def __init__(self, devices, graphs: bool = True):
        self.devices = [torch.device(d) for d in devices]
        self.graphs = [GraphCache() if graphs and d.type == "cuda" else None
                       for d in self.devices]
        self._copies = {}
        self._pool = ThreadPoolExecutor(max_workers=len(self.devices),
                                        thread_name_prefix="mesh-replica")

    def copies(self, modules) -> list[tuple]:
        key = tuple(id(m) for m in modules)
        if key not in self._copies:
            self._copies[key] = (modules, [
                tuple(copy.deepcopy(m).to(d) for m in modules)
                for d in self.devices])
        return self._copies[key][1]

    def _replica(self, fn, i, modules, rows, lo, hi):
        d = self.devices[i]
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            out = fn(i, d, self.graphs[i], modules, rows, lo, hi)
            if d.type == "cuda":
                torch.cuda.current_stream().synchronize()
        return out

    def run(self, fn, batch, modules, out):
        n = len(batch)
        cards = len(self.devices)
        (padded,), _ = pad_batch([np.asarray(batch)], cards)
        jobs = []
        for i, mods in enumerate(self.copies(modules)):
            lo, hi = slice_bounds(len(padded), cards, i)
            jobs.append(self._pool.submit(self._replica, fn, i, mods,
                                          padded[lo:hi], lo, hi))
        return _join([job.result() for job in jobs], n, out)


def _join(parts, n: int, out):
    """The replicas' outputs, tensors or tuples or dicts of them,
    concatenated in order on `out` and cut to the batch's n rows."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _join([p[k] for p in parts], n, out) for k in first}
    if isinstance(first, tuple):
        joined = [_join(list(xs), n, out) for xs in zip(*parts)]
        return (type(first)(*joined) if hasattr(first, "_fields")
                else tuple(joined))
    return torch.cat([x.to(out) for x in parts])[:n]
