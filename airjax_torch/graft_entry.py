"""__graft_entry__.py's entry points on the port: the one-card decode step
and the multi-device dry run.

  python3 -m airjax_torch.graft_entry [--torch-device cuda|cpu]

runs `entry()`'s step once on the card and prints `entry ok:` with its
output shapes, then the dry run over every card there is
(tools/dryrun_multichip.py); with --torch-device cpu, the step through the
kernels' plain versions and the dry run on one CPU shard. Without a card
and without --torch-device cpu it fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from airjax_torch.config import DEFAULT_CONFIG
from airjax_torch.dsp.demod import WINDOW
from airjax_torch.pipeline import decode_iq_block


def entry(*, device: torch.device | str = "cuda"):
    """-> (fn, example_args): the flagship decode step (__graft_entry__.py:
    12-28). One 20,000-sample IQ block (the reference's playback chunk)
    through the front and block-decode kernels: the preamble/DF17 gate,
    the ordered compaction, the bit slice, CRC check and repair."""
    cfg = DEFAULT_CONFIG
    n_off = cfg.block_len - WINDOW
    capacity = cfg.max_candidates

    def forward(iq: torch.Tensor) -> dict[str, torch.Tensor]:
        return decode_iq_block(iq, n_off, capacity)

    example = torch.zeros((cfg.block_len, 2), dtype=torch.int16, device=device)
    return forward, (example,)


def dryrun_multichip(n_devices: int, *, device: torch.device | str = "cuda", one_card: bool = False) -> None:
    """The multi-device dry run (__graft_entry__.py:31-190) over the first
    n_devices cards, n_devices shards of card 0 with one_card, or
    n_devices CPU shards with device="cpu": tools/dryrun_multichip.py's,
    which prints its `dryrun_multichip ok:` line; a failed check raises."""
    from airjax_torch.tools import dryrun_multichip as tool

    argv = [str(n_devices), "--torch-device", torch.device(device).type]
    tool.main(argv + (["--one-card"] if one_card else []))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a card) or the CPU's plain versions")
    args = p.parse_args(argv)
    fn, example = entry(device=args.torch_device)
    out = fn(*example)
    if args.torch_device == "cuda":
        torch.cuda.synchronize()
    print("entry ok:", {k: tuple(v.shape) for k, v in out.items()})
    dryrun_multichip(torch.cuda.device_count() if args.torch_device == "cuda" else 1, device=args.torch_device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
