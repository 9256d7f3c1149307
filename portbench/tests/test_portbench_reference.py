"""The plain reference against independent NumPy loops, over several
chained executions, on small shapes."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference

F = np.float32


def np_allreduce(x, k):
    n, e = x.shape
    c = e // n
    x = x.copy()
    for _ in range(k):
        out = np.empty_like(x)
        for ch in range(n):
            acc = x[(ch + 1) % n, ch * c:(ch + 1) * c].copy()
            for j in range(2, n + 1):
                acc = (acc + x[(ch + j) % n, ch * c:(ch + 1) * c]).astype(F)
            out[:, ch * c:(ch + 1) * c] = (acc * F(1.0 / n)).astype(F)
        x = out
    return x


def np_reduce_scatter(x, k):
    n, e = x.shape
    c = e // n
    x = x.copy()
    for _ in range(k):
        out = np.empty_like(x)
        for d in range(n):
            acc = x[(d + 1) % n, d * c:(d + 1) * c].copy()
            for j in range(2, n + 1):
                acc = (acc + x[(d + j) % n, d * c:(d + 1) * c]).astype(F)
            out[d] = np.tile((acc * F(1.0 / n)).astype(F), n)
        x = out
    return x


def np_all_to_all(x, k):
    n, e = x.shape
    c = e // n
    for _ in range(k):
        out = np.empty_like(x)
        for s in range(n):
            for d in range(n):
                out[d, s * c:(s + 1) * c] = x[s, d * c:(d + 1) * c]
        x = out
    return x


def np_write(x, k):
    block = min(reference.WRITE_BLOCK_ELEMS, x.shape[1])
    for _ in range(k):
        x = np.stack([np.resize(row[:block], row.shape) for row in x])
    return x


def np_stream(x, k):
    for _ in range(k):
        x = (x * F(1.0000001)).astype(F)
        x = (x + F(1e-7)).astype(F)
    return x


def np_triad(x, k):
    h = x.shape[1] // 2
    a, b = x[:, :h].copy(), x[:, h:].copy()
    for _ in range(k):
        a = ((a * F(1.0000001)).astype(F) + (b * F(1e-7)).astype(F)).astype(F)
    return np.concatenate([a, b], axis=1)


CASES = {
    "pl_allreduce": (8, 64, np_allreduce),
    "pl_reduce_scatter": (8, 64, np_reduce_scatter),
    "pl_all_to_all": (8, 64, np_all_to_all),
    "pl_hbm_copy": (1, 1000, lambda x, k: x),
    "pl_hbm_write": (1, 1024, np_write),
    "pl_hbm_stream": (1, 1000, np_stream),
    "hbm_triad": (1, 1000, np_triad),
}


def _input(shape, seed=7):
    return np.random.default_rng(seed).random(shape, dtype=F) + F(1)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 40])
@pytest.mark.parametrize("op", sorted(CASES))
def test_reference_matches_numpy(op, k):
    n, e, fn = CASES[op]
    x0 = _input((n, e))
    want = fn(x0, k)
    rows = list(range(n))
    got = torch.from_numpy(np.ascontiguousarray(want))
    assert reference.max_rel_gap(op, torch.from_numpy(x0), got, k,
                                 rows=rows, seed=3) == 0.0
    # one element a rounding off is seen
    bad = want.copy()
    bad[-1, -1] = np.nextafter(bad[-1, -1], F(3))
    if op not in ("pl_hbm_stream", "hbm_triad") or e <= reference.SAMPLE:
        assert reference.max_rel_gap(op, torch.from_numpy(x0),
                                     torch.from_numpy(bad), k, rows=rows,
                                     seed=3) > 0.0


@pytest.mark.parametrize("op", ["pl_allreduce", "pl_reduce_scatter",
                                "pl_all_to_all"])
def test_one_rank_of_a_world_is_held_to_its_row(op):
    n, e, fn = CASES[op]
    x0 = _input((n, e), seed=11)
    want = fn(x0, 5)
    for r in range(n):
        assert reference.max_rel_gap(
            op, torch.from_numpy(x0), torch.from_numpy(want[r].copy()), 5,
            rows=[r], seed=1) == 0.0
    if op == "pl_all_to_all":  # the reduced rows are alike by now
        assert reference.max_rel_gap(
            op, torch.from_numpy(x0), torch.from_numpy(want[0].copy()), 5,
            rows=[1], seed=1) > 0.0


@pytest.mark.parametrize("op", ["pl_all_gather", "pl_hbm_read"])
def test_an_op_whose_output_shows_nothing_has_no_reference(op):
    # the gather's carry takes its own chunk back out and the read writes
    # nothing: a buffer that went through them is its input either way
    x0 = torch.from_numpy(_input((8, 64)))
    with pytest.raises(ValueError, match="no reference"):
        reference.max_rel_gap(op, x0, x0.clone(), 3, rows=list(range(8)),
                              seed=0)


def test_an_even_count_of_all_to_alls_returns_the_input():
    x0 = _input((8, 64))
    assert reference.PERIOD_TWO == ("pl_all_to_all",)
    for k in (2, 10, 40):
        assert reference.max_rel_gap("pl_all_to_all", torch.from_numpy(x0),
                                     torch.from_numpy(x0.copy()), k,
                                     rows=list(range(8)), seed=0) == 0.0
    assert reference.max_rel_gap("pl_all_to_all", torch.from_numpy(x0),
                                 torch.from_numpy(x0.copy()), 11,
                                 rows=list(range(8)), seed=0) > 0.1


def test_replay_skips_a_cycle_exactly():
    # a rotation of period 5 from the start, and a clamp that settles
    step = lambda t: torch.roll(t, 1)  # noqa: E731
    x = torch.arange(5.0)
    for k in range(0, 23):
        assert torch.equal(reference.replay(step, x, k), torch.roll(x, k))
    clamp = lambda t: torch.clamp(t + 1, max=3.0)  # noqa: E731
    assert torch.equal(reference.replay(clamp, torch.zeros(2), 1000),
                       torch.full((2,), 3.0))


def test_large_elementwise_rows_compare_a_seeded_sample():
    pos = reference.sample_positions(5, 10**6)
    assert pos[0] == 0 and pos[-1] == 10**6 - 1
    assert len(pos) <= reference.SAMPLE + 2
    assert np.array_equal(pos, reference.sample_positions(5, 10**6))
    assert not np.array_equal(pos, reference.sample_positions(6, 10**6))
    x0 = _input((1, 10**5))
    want = np_stream(x0, 3)
    got = torch.from_numpy(want.copy())
    got[0, 5000:] = 0.0  # all but the first 5000 left unwritten
    assert reference.max_rel_gap("pl_hbm_stream", torch.from_numpy(x0), got,
                                 3, rows=[0], seed=5) > 0.5


def test_nan_is_an_infinite_gap():
    x0 = _input((1, 64))
    got = torch.from_numpy(x0.copy())
    got[0, 3] = float("nan")
    assert reference.max_rel_gap("pl_hbm_copy", torch.from_numpy(x0), got, 1,
                                 rows=[0], seed=0) == float("inf")


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((Path(reference.__file__)).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "numpy", "torch"}, names
