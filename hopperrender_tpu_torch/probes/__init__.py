"""The primitive probes P1-P4: the TPU's microbenchmark kernels of `scripts/`,
written again by hand for Hopper.

Each module holds one probe: a wrapper `run` of its CUDA kernel
(`csrc/<probe>.cu`) with a launch counter `run.launches`, the plain PyTorch
version `run_reference` that the wrapper takes for CPU tensors, and
`make_inputs`, the script's inputs made with numpy from a seed.

  chain_probe   P1  scripts/chain_probe.py   table-driven fetch chains, 12 variants
  chain_probe2  P2  scripts/chain_probe2.py  residual selects and dynamic gathers, 11
  gather_probe  P3  scripts/gather_probe.py  per-lane gathers, 3; and the block-gather
                                             rates in plain PyTorch
  mosaic_probe  P4  scripts/mosaic_probe.py  dynamic slices and rolls, 7

The probe path, the counterpart of `python scripts/<probe>.py [variant ...]`:

    python -m hopperrender_tpu_torch.probes {chain,chain2,gather,mosaic} [variant ...]
        [--device cuda|cpu] [--blocks 1|132] [--n1 N --n2 N]

Every dynamic window follows the JAX kernel as run in interpret mode: a
negative start counts from the end once, then the start is clamped so that
the window fits (P2's 256-row gather window starts at 256 when the table
asks for 448). P2's transpose8 does not trace in JAX, and `run` refuses it
the same way, before any launch.
"""
