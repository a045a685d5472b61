"""The work a cell does, counted from the benchmark's own shape tables:
operations and bytes of each conv and norm launch, and the peaks of the
card they are held against.

A table (`shapes/<model>.json`) lists the layers of one application of a
model to one row: each 3x3 or 1x1 conv as [H, W, Cin, Cout, k, dilation,
bias, count], each InstanceNorm++ as [H, W, C, count], each 2x2 stride-2
transposed conv as [H_in, W_in, Cin, Cout, count]. A conv does
2 B H W T Cin Cout operations over its T live taps (a dilated tap that
reaches past the whole image only ever multiplies padding, and these
inputs need none of it); its bytes are the input, the live taps'
weights, the bias and the output, each read or written once. A norm
reads its input and three parameter vectors once and writes its output
once. Nothing here reads the port: the same work is reckoned whatever
computes it.

A driver reports the work of a slice as counts of model applications:
  {"forward": {B: n}}               n forwards at batch B (no gradient)
  {"train": {B: n}}                 n training steps (forward, input
                                    gradient where the input needs one,
                                    weight gradient), batch B
  {"unrolled": {B: n}}              n LDAMP steps of `unrolls` denoiser
                                    applications with gradient, as many
                                    divergence forwards, their backward
and the compute dtype ("dtype") and the table ("model").
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple

SHAPES = Path(__file__).resolve().parent / "shapes"

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16, and float32 outside
# the tensor cores (TF32 off); HBM3 bandwidth. The card's power limit is
# printed beside every reading.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


class Conv(NamedTuple):
    H: int
    W: int
    Cin: int
    Cout: int
    k: int
    d: int
    bias: bool


@functools.lru_cache(maxsize=None)
def table(model: str) -> dict:
    return json.loads((SHAPES / f"{model}.json").read_text())


def live_taps(k: int, d: int, H: int, W: int) -> int:
    c = k // 2
    return (sum(abs((i - c) * d) < H for i in range(k))
            * sum(abs((i - c) * d) < W for i in range(k)))


def conv_flops(B: int, c: Conv) -> int:
    return 2 * B * c.H * c.W * live_taps(c.k, c.d, c.H, c.W) * c.Cin * c.Cout


def conv_bytes(B: int, c: Conv, es: int) -> int:
    T = live_taps(c.k, c.d, c.H, c.W)
    return (B * c.H * c.W * (c.Cin + c.Cout) + T * c.Cin * c.Cout
            + (c.Cout if c.bias else 0)) * es


def norm_bytes(B: int, H: int, W: int, C: int, es: int) -> int:
    return (2 * B * H * W * C + 3 * C) * es


def _convs(model: str) -> List[tuple]:
    return [(Conv(*row[:6], bool(row[6])), row[7])
            for row in table(model)["convs"]]


def _first_conv(model: str) -> Conv:
    """The conv that reads the model's input: its input gradient is never
    taken in training, since the data needs none."""
    return Conv(*table(model)["convs_first"][:6],
                bool(table(model)["convs_first"][6]))


def conv_launches(work: dict) -> Iterator[tuple]:
    """(B, conv, count) of every conv the slice ran as a conv kernel
    launch: forwards and, in training, the input gradients, each an
    input-gradient conv given as its own conv (Cin and Cout swapped, no
    bias)."""
    model = work["model"]
    for B, n in work.get("forward", {}).items():
        for c, m in _convs(model):
            yield int(B), c, m * n
    for key, per in (("train", 1), ("unrolled", work.get("unrolls", 1))):
        for B, n in work.get(key, {}).items():
            B = int(B)
            first = _first_conv(model)
            fwd = 2 if key == "unrolled" else 1  # the divergence probes
            for c, m in _convs(model):
                yield B, c, m * n * per * fwd
                dg = c._replace(Cin=c.Cout, Cout=c.Cin, bias=False)
                yield B, dg, (m * per - (c == first)) * n


def model_flops(work: dict) -> int:
    """Operations of the slice's convs and transposed convs: forwards,
    and in training input and weight gradients (elementwise work and
    norms are not counted)."""
    model = work["model"]
    total = sum(conv_flops(B, c) * n for B, c, n in conv_launches(work))
    t = table(model)
    for key, per in (("train", 1), ("unrolled", work.get("unrolls", 1))):
        for B, n in work.get(key, {}).items():
            total += sum(conv_flops(int(B), c) * m * per * n
                         for c, m in _convs(model))  # weight gradients
            # transposed convs: forward (and probe), input and weight grads
            fwd = 2 if key == "unrolled" else 1
            for Hi, Wi, Ci, Co, m in t.get("tconvs", []):
                f = 2 * int(B) * Hi * Wi * 4 * Ci * Co
                total += f * m * per * n * (fwd + 2)
    for B, n in work.get("forward", {}).items():
        for Hi, Wi, Ci, Co, m in t.get("tconvs", []):
            total += 2 * int(B) * Hi * Wi * 4 * Ci * Co * m * n
    return total


def norm_launches(work: dict) -> Iterator[tuple]:
    """(B, H, W, C, count) of the InstanceNorm++ launches of forwards."""
    for B, n in work.get("forward", {}).items():
        for H, W, C, m in table(work["model"]).get("norms", []):
            yield int(B), H, W, C, m * n
    for B, n in work.get("train", {}).items():
        for H, W, C, m in table(work["model"]).get("norms", []):
            yield int(B), H, W, C, m * n


def roofline_seconds(launches, dtype: str, kind: str = "conv") -> float:
    """The least time the card could take for these launches: each the
    larger of its operations over the peak and its bytes over the
    bandwidth."""
    es = ELEMENT_BYTES[dtype]
    total = 0.0
    if kind == "conv":
        for B, c, n in launches:
            total += n * max(conv_flops(B, c) / PEAK_FLOPS[dtype],
                             conv_bytes(B, c, es) / PEAK_BYTES)
    else:
        for B, H, W, C, n in launches:
            total += n * norm_bytes(B, H, W, C, es) / PEAK_BYTES
    return total


def counts(work: dict) -> Dict[str, int]:
    """Conv and norm launches of a slice, for the record."""
    return {"conv": sum(n for _, _, n in conv_launches(work)),
            "norm": sum(n for *_, n in norm_launches(work))}
