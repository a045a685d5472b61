"""Offline data set generation CLI (reference matlab/generate_data.m), the
counterpart of the JAX package's data/generate.py:13.

Writes `output_h` files in the reference naming
(`<profile>_Nt64_Nr16_ULA0.50_seed<seed>.npz`, loaders.py:23-24) for each
(profile, spacing, seed), made on the host by the port's CDL generator
(`--backend torch`, data/cdl.py) or the native C++ one (`--backend
native`, data/cdl_native.py); `auto` takes the native one when it builds
and says which it used.
"""

from __future__ import annotations

import numpy as np


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate CDL channel datasets")
    p.add_argument("--profiles", nargs="+", type=str,
                   default=["CDL-B", "CDL-C", "CDL-D"])  # generate_data.m:5
    p.add_argument("--spacings", nargs="+", type=float, default=[0.5])
    p.add_argument("--seeds", nargs="+", type=int, default=[1234, 4321])
    p.add_argument("--num_channels", type=int, default=200)
    p.add_argument("--num_rx", type=int, default=16)
    p.add_argument("--num_tx", type=int, default=64)
    p.add_argument("--out_dir", type=str, default="./data")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "torch", "native"])
    args = p.parse_args(argv)

    from .cdl import generate_cdl_channels
    from .cdl_native import (
        generate_cdl_channels_native, library_path, load_library,
        native_available,
    )
    from .dataset import channel_filename
    from .io import save_output_h

    gen = generate_cdl_channels
    if args.backend == "native" or (args.backend == "auto"
                                    and native_available()):
        gen = generate_cdl_channels_native
        load_library()  # raises NativeUnavailable when the build fails
        print(f"# using the native C++ generator ({library_path()})")
    else:
        print("# using the torch generator (data/cdl.py)")

    for profile in args.profiles:
        for spacing in args.spacings:
            for seed in args.seeds:
                H = gen(
                    seed=seed, profile=profile, num_channels=args.num_channels,
                    num_rx=args.num_rx, num_tx=args.num_tx, spacing=spacing)
                path = channel_filename(args.out_dir, profile, args.num_tx,
                                        args.num_rx, spacing, seed)
                save_output_h(path, H)
                print(f"wrote {path}  shape {H.shape}  "
                      f"power {np.mean(np.abs(H) ** 2):.3f}")


if __name__ == "__main__":
    main()
