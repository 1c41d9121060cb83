"""`python -m grove_tpu_torch.initc` — the init-container entry point.

Exit codes mirror the reference binary (initc/cmd/main.go): 0 = all parent
cliques ready, 1 = timeout waiting, 2 = bad arguments.
"""

from __future__ import annotations

import argparse
import sys

from grove_tpu_torch.initc.agent import http_fetch, parse_podcliques_arg, wait_until_ready


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="grove-initc")
    parser.add_argument(
        "--podcliques",
        required=True,
        help="comma-separated <cliqueFQN>:<minAvailable> gates",
    )
    parser.add_argument(
        "--server",
        default="http://127.0.0.1:2751",
        help="manager HTTP API base (apiserver analog)",
    )
    parser.add_argument("--poll-interval", type=float, default=1.0)
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument(
        "--token", default="", help="SA bearer token (authorizer-enabled managers)"
    )
    parser.add_argument(
        "--token-file", default="", help="file holding the SA token (mount analog)"
    )
    parser.add_argument(
        "--cafile", default="", help="CA bundle pinning an https manager's cert"
    )
    parser.add_argument(
        "--kube",
        action="store_true",
        help="gate on the kube-apiserver directly (the reference agent's "
        "path, wait.go:111-164) instead of the operator HTTP API; --server "
        "defaults to the in-cluster apiserver, --cafile to the mounted "
        "cluster CA",
    )
    parser.add_argument(
        "--namespace",
        default="",
        help="pod namespace for --kube (default: the in-cluster namespace "
        "file, else 'default')",
    )
    args = parser.parse_args(argv)
    token = args.token
    if args.token_file:
        try:
            with open(args.token_file) as f:
                token = f.read().strip()
        except OSError as e:
            # Mount missing (authorizer likely off): proceed tokenless — the
            # 401 fail-fast path catches a genuinely required credential.
            print(f"grove-initc: no token file ({e}); proceeding without", file=sys.stderr)

    try:
        reqs = parse_podcliques_arg(args.podcliques)
    except ValueError as e:
        print(f"grove-initc: {e}", file=sys.stderr)
        return 2
    if not reqs:
        return 0

    if args.kube:
        import os

        from grove_tpu_torch.initc.agent import (
            IN_CLUSTER_SA_DIR,
            in_cluster_server,
            kube_fetch,
        )

        # --server set explicitly wins (tests point it at a fixture);
        # otherwise the standard in-cluster env names the apiserver.
        server = args.server if args.server != parser.get_default("server") else None
        server = server or in_cluster_server()
        if server is None:
            print(
                "grove-initc: --kube but no --server and no in-cluster env "
                "(KUBERNETES_SERVICE_HOST)",
                file=sys.stderr,
            )
            return 2
        namespace = args.namespace
        if not namespace:
            try:
                with open(f"{IN_CLUSTER_SA_DIR}/namespace") as f:
                    namespace = f.read().strip()
            except OSError:
                namespace = "default"
        cafile = args.cafile or None
        if cafile is None and os.path.isfile(f"{IN_CLUSTER_SA_DIR}/ca.crt"):
            cafile = f"{IN_CLUSTER_SA_DIR}/ca.crt"
        fetch = kube_fetch(server, namespace, token=token or None, cafile=cafile)
    else:
        fetch = http_fetch(
            args.server, token=token or None, cafile=args.cafile or None
        )

    def log_poll(n: int) -> None:
        if n == 1 or n % 30 == 0:
            print(f"grove-initc: waiting on {len(reqs)} parent clique(s)", flush=True)

    try:
        ok = wait_until_ready(
            fetch,
            reqs,
            timeout_s=args.timeout,
            poll_interval_s=args.poll_interval,
            on_poll=log_poll,
        )
    except PermissionError as e:
        print(f"grove-initc: {e}", file=sys.stderr)
        return 2
    if not ok:
        print("grove-initc: timed out waiting for parent cliques", file=sys.stderr)
        return 1
    print("grove-initc: all parent cliques ready", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
