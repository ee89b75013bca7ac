"""Quickstart for the PyTorch/CUDA port: the paper's 7-D fold decomposition
in six steps, with the port's fold kernel on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On a CUDA device step 5 launches the CUDA fold kernel; with ``--device
cpu`` it runs the kernel's plain-torch fold loop.
"""
import argparse

import torch

from repro_torch.core import (ConvLoopNest, MavecConfig, PEArray, decompose,
                              execute_conv_by_folds, layer_perf)
from repro_torch.core.mapping import (plan_conv_blocks,
                                      weight_stationary_conv_plan)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    dev = resolve_device(ap.parse_args().device)

    # 1. A convolution layer is a 7-D loop nest (N, N_F, C, R, S, P, Q).
    cv = ConvLoopNest(n=1, nf=64, c=64, r=3, s=3, x=56, y=56, stride=1,
                      pad=1)
    print(f"workload {cv}: dims={cv.dims()}  MACs={cv.macs:,}")

    # 2. Decompose it onto a PE array: Filter Folds / Image Blocks / Image
    #    Folds.
    plan = decompose(cv, PEArray(64, 64))
    print(f"fold plan: {plan.summary()}")

    # 3. The analytical model predicts utilization, latency, throughput
    #    (eqs 6-15) before anything runs.
    perf = layer_perf(cv, PEArray(64, 64), MavecConfig())
    print(f"predicted: util={perf.util_avg_pct:.1f}%  "
          f"T_ops={perf.t_ops:,} cycles  {perf.gflops:.0f} GFLOP/s")

    # 4. The fold schedule computes the real convolution (validated against
    #    one F.conv2d call at full fp32, the "torch" oracle).
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 8, 12, 12, generator=gen, device=dev)
    w = torch.randn(4, 8, 3, 3, generator=gen, device=dev)
    small = ConvLoopNest(n=1, nf=4, c=8, r=3, s=3, x=12, y=12, stride=1,
                         pad=1)
    out = execute_conv_by_folds(x, w, small, PEArray(4, 24))
    ref = ops.conv2d(x, w, stride=1, pad=1, impl="torch")
    print(f"fold-schedule max |err| vs F.conv2d: "
          f"{(out - ref).abs().max().item():.2e}")

    # 5. The same fold geometry solves the block plan the fold kernel runs.
    bp = plan_conv_blocks(cv)
    print(f"block plan: nf_block={bp.nf_block} c_block={bp.c_block} "
          f"p_block={bp.p_block} grid={bp.grid} "
          f"working set={bp.vmem_bytes / 2**20:.1f}MiB")
    out2 = ops.conv2d(x, w, stride=1, pad=1, impl="fold_os")
    what = "CUDA" if dev.type == "cuda" else "plain-torch"
    print(f"{what} fold kernel (output-stationary) max |err|: "
          f"{(out2 - ref).abs().max().item():.2e}")

    # 6. The directive algebra that generalizes the mapping to LMs.
    print(weight_stationary_conv_plan(cv))


if __name__ == "__main__":
    main()
