"""Module entry point: python -m hybridsearch_tpu_torch <command>
(the port of hybridsearch_tpu/__main__.py)."""

from hybridsearch_tpu_torch.api.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
