"""The port's CLI entry point (counterpart of ife_tpu/cli/main.py).

One subcommand per reference tool: every ife_tpu subcommand. Run as ``python -m ife_tpu_torch <subcommand>``.
"""
from __future__ import annotations

import argparse
import sys

from ife_tpu_torch.cli import commands as C


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ife_tpu_torch",
        description="Dense 3D feature extraction on PyTorch + CUDA "
        "(capabilities of orting/image-feature-extraction)",
    )
    sub = p.add_subparsers(dest="command", required=True, metavar="COMMAND")

    for name, (configure, run, help_) in C.REGISTRY.items():
        sp = sub.add_parser(name, help=help_, description=help_)
        configure(sp)
        sp.set_defaults(_run=run)

    args = p.parse_args(argv)
    try:
        return args._run(args) or 0
    except BrokenPipeError:
        return 0
    except Exception as e:  # context-rich stderr + failure exit, like the
        # reference tools' try/catch around Update() (MakeBag.cxx:408-439)
        print(f"ife_tpu_torch {args.command}: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
