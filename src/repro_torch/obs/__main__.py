"""Trace-tooling CLI.

    python -m repro_torch.obs summary trace.jsonl      # CSV stage summary
    python -m repro_torch.obs export  trace.jsonl      # Chrome/Perfetto JSON
    python -m repro_torch.obs diff    base.jsonl head.jsonl
    python -m repro_torch.obs dash    trace.jsonl -o report.html
    python -m repro_torch.obs metrics trace.jsonl      # Prometheus text

``python -m repro_torch.obs trace.jsonl`` (no subcommand) keeps the historic
behavior and prints the summary.

Counterpart of ``repro/obs/__main__.py``, copied.
"""
import sys

_COMMANDS = ("summary", "export", "diff", "dash", "metrics")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv[0] if argv and argv[0] in _COMMANDS else None
    if cmd is None:
        if argv and argv[0] in ("-h", "--help"):
            print(__doc__.strip())
            return
        # historic form: first arg is a trace file -> summary
        cmd, args = "summary", argv
    else:
        args = argv[1:]
    if cmd == "summary":
        from .summary import main as run
    elif cmd == "export":
        from .export import main as run
    elif cmd == "diff":
        from .diff import main as run
    elif cmd == "dash":
        from .dash import main as run
    else:
        from .metrics import main as run
    run(args)


if __name__ == "__main__":
    main()
