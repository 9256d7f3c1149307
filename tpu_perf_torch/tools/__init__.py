"""Measurement tools for the port's developers, run on a card with
``python -m tpu_perf_torch.tools.<name>``: ``compare_trees`` times two
checkouts in turns, ``row_copy_designs`` the row-copy kernels' designs.
Neither is on a run path."""
