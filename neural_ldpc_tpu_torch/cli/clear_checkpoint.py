"""Delete a checkpoint directory (parity with the reference's
``clear_checkpoint`` rye script, reference pyproject.toml:33-37)."""

from __future__ import annotations

import argparse
import os
import shutil
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="delete a checkpoint directory")
    p.add_argument("--dir", default="checkpoints")
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    args = p.parse_args(argv)
    if not os.path.isdir(args.dir):
        print(f"{args.dir}: not a directory (nothing to clear)")
        return 0
    if not args.yes:
        reply = input(f"delete '{args.dir}' and everything under it? [y/N] ")
        if reply.strip().lower() not in ("y", "yes"):
            print("aborted")
            return 1
    shutil.rmtree(args.dir)
    print(f"removed {args.dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
