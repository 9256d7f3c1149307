"""``python -m tpu_perf_torch`` entry point."""

from tpu_perf_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
