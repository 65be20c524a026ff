"""Floating-point operations of the model's work, from its shapes: a
multiply-add counts two. Elementwise nonlinearities (tanh, sigmoid, exp,
ReLU) and the optimizer's update are not counted: the float32 peak that
these are compared with counts fused multiply-adds."""

from __future__ import annotations

from satbench.reference.model import VGG19_CONVS


def vgg19(images: int, size: int) -> int:
    """The 16 3x3 convolutions of VGG19 at size x size px."""
    total, cin, side = 0, 3, size
    for entry in VGG19_CONVS:
        if entry == "M":
            side //= 2
            continue
        total += 2 * images * side * side * 9 * cin * entry
        cin = entry
    return total


def _attention(rows: int, L: int, D: int, E: int) -> int:
    """U h, the score (add, then v's multiply-add) and the context."""
    return 2 * rows * E * E + 3 * rows * L * E + 2 * rows * L * D


def _cell(rows: int, D: int, E: int) -> int:
    """The gate f_beta and the LSTM's two products."""
    return 2 * rows * E * D + 2 * rows * (E + D) * 4 * E + 2 * rows * E * 4 * E


def _ado(rows: int, D: int, E: int, V: int) -> int:
    """f_h, f_z and f_out of the advanced deep output."""
    return 2 * rows * E * E + 2 * rows * D * E + 2 * rows * E * V


def _start(images: int, L: int, D: int, E: int) -> int:
    """The keys W a (every grid row) and init_h, init_c."""
    return 2 * images * L * D * E + 2 * 2 * images * D * E


def beam_decode(images: int, beam: int, steps: int, L: int, D: int, E: int,
                V: int) -> int:
    """A beam decode of `steps` steps over images x beam rows, the
    candidates' top-k not counted."""
    rows = images * beam
    return (_start(images, L, D, E)
            + steps * (_attention(rows, L, D, E) + _cell(rows, D, E)
                       + _ado(rows, D, E, V)))


def caption_batch(images: int, size: int, beam: int, steps: int, L: int,
                  D: int, E: int, V: int) -> int:
    return vgg19(images, size) + beam_decode(images, beam, steps, L, D, E, V)


def train_step(batch: int, T: int, L: int, D: int, E: int, V: int) -> int:
    """One teacher-forced step over T tokens a row, forward and backward.
    The backward of a product whose both operands need a gradient costs
    twice its forward, of one whose input is the bank's (the keys) once;
    the attention middle's backward is counted as its forward twice. A
    recomputed forward (remat) is not counted: it is not the model's
    work."""
    fwd = (_start(batch, L, D, E) + T * (_attention(batch, L, D, E)
                                         + _cell(batch, D, E))
           + _ado(batch * T, D, E, V))
    keys = 2 * batch * L * D * E
    return fwd + 2 * (fwd - keys) + keys
