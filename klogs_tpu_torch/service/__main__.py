"""``python -m klogs_tpu_torch.service``: run filterd.

Counterpart of ``python -m klogs_tpu.service``, with its flags.
``--backend cuda`` (the default) serves the GPU engine and raises
without a card, as every entry point of the port does; ``--backend
cpu`` serves the host engines (filters/cpu.py) and never touches the
card. ``--multi-set`` serves the pattern-set registry (collectors
register their own sets; ``--match`` and ``--exclude`` become the
optional set of collectors that do not).
"""

import argparse
import asyncio
import sys

from klogs_tpu_torch.filters.compiler.parser import RegexSyntaxError
from klogs_tpu_torch.service.server import serve


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="klogs-filterd",
        description="klogs_tpu_torch filter service: owns the GPU engine, "
        "serves Match RPCs to log collectors",
    )
    ap.add_argument("--match", action="append", default=[],
                    help="regex pattern to KEEP (repeatable)")
    ap.add_argument("--exclude", action="append", default=[],
                    help="regex pattern to DROP even when kept "
                    "(repeatable; alone = keep all non-matching)")
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                    help="filter engine: batch NFA on the GPU (cuda) or "
                    "the host engines (cpu: indexed, DFA, combined re, re)")
    ap.add_argument("--multi-set", action="store_true", dest="multi_set",
                    help="multi-tenant registry mode: collectors "
                    "register their own pattern sets (content-addressed "
                    "— identical sets share one engine) and are "
                    "admitted weighted-fair with per-set quotas; "
                    "--match/--exclude become the optional default set "
                    "for collectors that do not register "
                    "(KLOGS_TENANT_* env knobs)")
    ap.add_argument("-I", "--ignore-case", action="store_true",
                    dest="ignore_case",
                    help="case-insensitive patterns (collectors must "
                    "connect with matching -I or the pattern handshake "
                    "rejects them)")
    ap.add_argument("--host", default="127.0.0.1",
                    help='bind address; "unix:/path.sock" serves a Unix '
                    "domain socket (co-located collector deployments)")
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--tls-cert", help="PEM server certificate (enables TLS)")
    ap.add_argument("--tls-key", help="PEM server private key")
    ap.add_argument("--tls-client-ca",
                    help="PEM CA bundle; require+verify client certs (mTLS)")
    ap.add_argument("--auth-token-file",
                    help="file with a shared bearer token (e.g. a mounted "
                    "Kubernetes Secret); RPCs without it are rejected")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus /metrics plus /healthz "
                    "(liveness) and /readyz (readiness; unready until "
                    "the warmup batch has gone through the card) on "
                    "this HTTP port (0 = ephemeral; binds 127.0.0.1)")
    ap.add_argument("--trace-json", default=None, dest="trace_json",
                    metavar="PATH",
                    help="write every finished trace span as one JSON "
                    "line to PATH (server-side batch tracing; continues "
                    "a collector's trace when its RPC carries the "
                    "traceparent metadata). Implies KLOGS_TRACE_SAMPLE=1 "
                    "unless that variable is set")
    ap.add_argument("--profile-json", default=None, dest="profile_json",
                    metavar="PATH",
                    help="append one JSON line per profiler tick to "
                    "PATH: per-stage busy-seconds/utilization, queue/"
                    "in-flight samples, and the offered/admitted/"
                    "headroom capacity block. Enables the continuous "
                    "pipeline profiler (KLOGS_PROFILE_SAMPLE pins the "
                    "span-sampling rate; 0 disables). The same "
                    "snapshot serves /profile on --metrics-port")
    ap.add_argument("--metrics-host", default="127.0.0.1",
                    metavar="HOST",
                    help="metrics/health bind address; the loopback "
                    "default keeps the sidecar private")
    return ap


def main(argv: "list[str] | None" = None, device=None) -> None:
    """Parse, check the token file, then serve until interrupted.
    ``device=None`` means ``"cuda"``."""
    ap = build_parser()
    ns = ap.parse_args(argv)
    if ns.auth_token_file:
        # Fail fast on a bad path or an empty file; the server reads the
        # file again for each RPC, so a rotated Secret needs no restart.
        try:
            with open(ns.auth_token_file) as f:
                if not f.read().strip():
                    ap.error(f"--auth-token-file {ns.auth_token_file} is empty")
        except OSError as e:
            ap.error(f"cannot read --auth-token-file: {e}")
    try:
        asyncio.run(serve(ns.match, ns.backend, ns.host, ns.port,
                          ignore_case=ns.ignore_case,
                          multi_set=ns.multi_set,
                          tls_cert=ns.tls_cert, tls_key=ns.tls_key,
                          tls_client_ca=ns.tls_client_ca,
                          auth_token_file=ns.auth_token_file,
                          exclude=ns.exclude,
                          metrics_port=ns.metrics_port,
                          metrics_host=ns.metrics_host,
                          trace_json=ns.trace_json,
                          profile_json=ns.profile_json,
                          device=device))
    except KeyboardInterrupt:
        pass
    except RegexSyntaxError as e:  # a ValueError: caught first
        print(f"unsupported --match pattern: {e}", file=sys.stderr)
        raise SystemExit(1)
    except ValueError as e:
        # FilterServer's checks (TLS pairing, an empty set, a metrics
        # port that cannot bind) as one line.
        print(f"klogs-filterd: {e}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
