"""Operator binary entry point: `python -m grove_tpu_torch.runtime --config
<yaml> [--run-for S] [--device cpu]` (grove_tpu/runtime/__main__.py
counterpart).

Mirror of `operator/cmd/main.go:46-128` + `cmd/cli/cli.go`: parse flags, load
and validate the OperatorConfiguration (exit non-zero listing every problem),
boot the manager, run until SIGINT/SIGTERM. The solves run on the card;
without one the binary exits non-zero unless `--device cpu` asks for the
plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="grove-tpu-operator")
    parser.add_argument("--config", required=True, help="OperatorConfiguration YAML")
    parser.add_argument(
        "--run-for", type=float, default=None, help="exit after N seconds (testing)"
    )
    parser.add_argument(
        "--device", default=None,
        help="where the solves run: the card (default) or 'cpu' for the plain versions",
    )
    from grove_tpu_torch.version import version_string

    parser.add_argument(
        "--version", action="version", version=version_string("grove-tpu")
    )
    args = parser.parse_args(argv)

    from grove_tpu_torch.runtime.config import load_operator_config
    from grove_tpu_torch.runtime.manager import Manager

    try:
        config = load_operator_config(args.config)
    except (OSError, ValueError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    # The solves run on the card: no card is an error unless the caller
    # asked for the CPU (no fallback).
    from grove_tpu_torch.utils.platform import ensure_usable_backend

    try:
        _, described = ensure_usable_backend(args.device)
    except RuntimeError as e:
        print(f"platform error: {e}", file=sys.stderr)
        return 3
    print(f"grove-tpu-operator: solves on {described}", file=sys.stderr, flush=True)

    manager = Manager(config, device=args.device)

    def _stop(signum, frame):
        manager.stop()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    try:
        manager.run(stop_after_seconds=args.run_for)
    finally:
        manager.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
