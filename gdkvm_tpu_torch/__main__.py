"""``python -m gdkvm_tpu_torch <command> ...``: the command line (cli.py)."""

from gdkvm_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
