"""The largest eigenvalue of each pilot Gram P P^H, LDAMP's step size eig1
(csrc/pilot_eigmax.cu), and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package computes eig1 with eigvalsh on
the host's batch. LDAMP's training step assembles its batch on the card
from the host's draws (train/ldamp.py::ldamp_inputs), inside its CUDA
graph, and `torch.linalg.eigvalsh` on the card reads its solver's status
on the host, which a capture cannot hold.

P is (B, Nt, Np, 2) float32 c2, contiguous. The kernel runs one-sided
Jacobi over the shorter side of each sample's P in shared memory, one
block a sample, and reads lambda_max as the Rayleigh quotient of P P^H at
the largest of the orthogonalised columns (design notes in the source).
Bound on an H100: latency, not bytes (2.5 MB at B = 128, 64 x 38) nor
operations (~2 GFLOP): a sample's 7-9 sweeps of 37 rounds run one after
the other.

`pilot_eigmax` dispatches on the tensor's device: a CPU tensor goes to
`pilot_eigmax_plain` (eigvalsh of P P^H, eig1 as the JAX package's data
set computes it); a CUDA tensor launches the kernel or raises. Both count
their calls in COUNTS. The kernel also returns the sweeps each sample
took (int32 on the card, read by no one on the step's path: no host
sync).

    python -m score_based_channels_torch.kernels.eigmax

times the kernel, the plain version and `torch.linalg.eigvalsh` of the
Grams on the card at B = 128, 64 x 38, and prints their worst error
against float64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

COUNTS = {"launches": 0, "plain": 0}


def max_sweeps() -> int:
    """The kernel's cap on a sample's sweeps."""
    from . import _build

    return _build.library().sbc_pilot_eigmax_max_sweeps()


def pilot_eigmax_plain(P: torch.Tensor) -> torch.Tensor:
    """lambda_max(P P^H) of (B, Nt, Np, 2) c2 pilots -> (B,) float32, as
    the JAX package's data set computes eig1 (eigvalsh of the Gram)."""
    COUNTS["plain"] += 1
    Pc = torch.view_as_complex(P.contiguous())
    gram = Pc @ Pc.transpose(-1, -2).conj().resolve_conj()
    return torch.linalg.eigvalsh(gram)[..., -1].float()


def _check_cuda(P: torch.Tensor) -> None:
    from . import _build

    if P.dtype != torch.float32:
        raise TypeError(f"pilot_eigmax takes float32 c2 pilots, got "
                        f"{P.dtype}")
    if P.dim() != 4 or P.shape[-1] != 2 or P.shape[0] < 1:
        raise ValueError(f"pilot_eigmax takes (B, Nt, Np, 2) pilots, got "
                         f"{tuple(P.shape)}")
    if not P.is_contiguous():
        raise ValueError("pilot_eigmax takes contiguous pilots")
    Nt, Np = P.shape[1:3]
    if not _build.library().sbc_pilot_eigmax_fits(Nt, Np):
        raise ValueError(f"pilot_eigmax: {Nt} x {Np} pilots exceed the "
                         f"kernel's longer side or a block's shared memory")


def _launch(P: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from . import _build

    B, Nt, Np = P.shape[:3]
    eig = torch.empty(B, dtype=torch.float32, device=P.device)
    sweeps = torch.empty(B, dtype=torch.int32, device=P.device)
    rc = _build.library().sbc_pilot_eigmax(
        P.data_ptr(), eig.data_ptr(), sweeps.data_ptr(), B, Nt, Np,
        torch.cuda.current_stream(P.device).cuda_stream)
    _build.check("pilot_eigmax", rc)
    COUNTS["launches"] += 1
    return eig, sweeps


def pilot_eigmax(P: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(lambda_max(P P^H) (B,) float32, the sweeps each sample took (B,)
    int32, None from the plain version) of (B, Nt, Np, 2) c2 pilots, on
    their device."""
    if P.device.type == "cpu":
        return pilot_eigmax_plain(P), None
    if P.device.type != "cuda":
        raise RuntimeError(f"pilot_eigmax: no kernel for {P.device}")
    _check_cuda(P)
    return _launch(P)


def operations(Nt: int, Np: int, sweeps: torch.Tensor) -> int:
    """Floating-point operations of a launch whose samples took `sweeps`
    sweeps: in each sweep every pair's four sums (16 a complex element)
    and its rotation (24), over the L = max(Nt, Np) elements; an upper
    count, since a pair already orthogonal skips its rotation."""
    n, L = min(Nt, Np), max(Nt, Np)
    return int(sweeps.sum().item()) * (n * (n - 1) // 2) * L * 40


def measure(P: torch.Tensor, reps: int = 50) -> dict:
    """The kernel on (B, Nt, Np, 2) card pilots beside the plain version
    on the same card tensor and `torch.linalg.eigvalsh` of the Grams
    alone: ms a call each (CUDA events over `reps` calls), each one's
    worst relative error against float64 eigvalsh, the kernel's against
    the plain version's, its sweeps and `operations`."""
    Pc = torch.view_as_complex(P).to(torch.complex128)
    want = torch.linalg.eigvalsh(Pc @ Pc.mH)[..., -1]
    gram = torch.view_as_complex(P) @ torch.view_as_complex(P).mH
    fns = {"kernel": lambda: pilot_eigmax(P)[0],
           "plain": lambda: pilot_eigmax_plain(P),
           "library": lambda: torch.linalg.eigvalsh(gram)[..., -1]}
    out = {}
    for name, fn in fns.items():
        got = fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = got
        out[f"{name}_ms"] = start.elapsed_time(end) / reps
        out[f"{name}_err"] = ((got.double() - want).abs()
                              / want).max().item()
    out["kernel_vs_plain"] = ((out.pop("kernel") - out["plain"]).abs()
                              / out.pop("plain")).max().item()
    del out["library"]
    sweeps = pilot_eigmax(P)[1]
    out.update(sweeps_min=sweeps.min().item(),
               sweeps_max=sweeps.max().item(), max_sweeps=max_sweeps(),
               operations=operations(P.shape[1], P.shape[2], sweeps),
               bytes=P.numel() * 4 + P.shape[0] * 8)
    return out


def _bench(argv=None) -> None:
    """Kernel, plain version and eigvalsh of the Grams on the card."""
    import argparse

    from .. import cplx

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--num_tx", type=int, default=64)
    p.add_argument("--num_pilots", type=int, default=38)
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the kernel runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    P = cplx.qpsk_pilots(torch.Generator().manual_seed(0), args.batch,
                         args.num_tx, args.num_pilots).to("cuda")
    m = measure(P, args.reps)
    for name in ("kernel", "plain", "library"):
        print(f"{name}: {m[name + '_ms']:.4f} ms for {args.batch} x "
              f"({args.num_tx}, {args.num_pilots}), worst relative error "
              f"{m[name + '_err']:.2e} against float64 on "
              f"{torch.cuda.get_device_name(0)}")
    print(f"sweeps: {m['sweeps_min']}-{m['sweeps_max']} of at most "
          f"{m['max_sweeps']}; kernel against plain {m['kernel_vs_plain']:.2e}")


if __name__ == "__main__":
    _bench()
