"""The port's split-channel contention (``contend --split K``,
``streams.contend.build_split_steps``) against the JAX package's on the
CPU.

K ppermute lanes, each moving its slice of every rank's payload along one
of the linkmap planner's link-disjoint ring shifts: pinned to one
schedule, the lanes' concatenated output equals the single-channel
full-payload output (exact, a copy), K = 2 and 4, and each lane's output
equals JAX's lane on its 8 CPU devices; the lane plan (schedules, slice
sizes) is JAX's; a synthetic split race writes JAX's rows; a real one on
8 sim CPU ranks writes idle and loaded rows the interference matrix
reads; and the CLI refuses what JAX's refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_perf.config import Options as JOptions
from tpu_perf.streams import contend as jcontend

from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.linkmap import plan_mesh_links
from tpu_perf_torch.streams.contend import (
    _split_k, build_split_steps, run_contend,
)
from tpu_perf_torch.world import SimWorld, from_world

CPU = torch.device("cpu")


@pytest.mark.parametrize("load", ["split:2", "split:4", "split:16", "",
                                  "hbm_stream", "split:1", "split:x",
                                  "split:"])
def test_the_split_spelling_is_jaxs(load):
    try:
        want = jcontend._split_k(load)
    except ValueError:
        with pytest.raises(ValueError, match="split:K"):
            _split_k(load)
        return
    assert _split_k(load) == want


@pytest.mark.parametrize("k", [2, 4])
def test_lanes_reassemble_the_single_channel_output(k):
    world = SimWorld(8, CPU)
    sched = plan_mesh_links((8,), ("x",))[0]
    (single, _, whole, _), = build_split_steps(world, 1024, 3, 1,
                                              schedules=[sched])
    lanes = build_split_steps(world, 1024, 3, k, schedules=[sched])
    assert len(lanes) == k and all(n == sched.name for *_, n in lanes)
    widths = [nb // 4 for _, _, nb, _ in lanes]
    assert sum(widths) == whole // 4
    full = torch.arange(8 * sum(widths), dtype=torch.float32).view(8, -1)
    outs, lo = [], 0
    for (step, _, _, _), w in zip(lanes, widths):
        outs.append(step(full[:, lo:lo + w].contiguous()))
        lo += w
    assert torch.equal(torch.cat(outs, dim=1), single(full))


@pytest.mark.parametrize("k,nbytes", [(2, 4096), (4, 1000), (3, 64)])
def test_each_lane_is_jaxs(k, nbytes, eight_devices):
    from tpu_perf.parallel import make_mesh as jmesh

    ours = build_split_steps(SimWorld(8, CPU), nbytes, 2, k)
    theirs = jcontend.build_split_steps(jmesh((8,), ("x",)), nbytes, 2, k)
    assert [(nb, name) for _, _, nb, name in ours] == \
        [(nb, name) for _, _, nb, name in theirs]
    for (step, x, _, _), (jstep, jx, _, _) in zip(ours, theirs):
        np.testing.assert_array_equal(from_world(x), np.asarray(jx))
        np.testing.assert_array_equal(from_world(step(x)),
                                      np.asarray(jstep(jx)))


def _rows(rows):
    return [dataclasses.replace(r, timestamp="", job_id="").to_csv()
            for r in rows]


@pytest.mark.parametrize("k", [2, 4])
def test_a_synthetic_split_race_writes_jaxs_rows(k):
    kw = dict(op="ppermute", buff_sz=32768, iters=10, num_runs=6,
              synthetic_s=0.001, fault_seed=7, load=f"split:{k}")
    ours = run_contend(Options(**kw), n_devices=8)
    theirs = jcontend.run_contend(JOptions(**kw), n_devices=8)
    assert _rows(ours) == [r.replace(",jax,", ",torch-sim,")
                           for r in _rows(theirs)]
    assert {r.load for r in ours} == {"", f"split:{k}"}
    assert {r.stream for r in ours} == {0}


def test_a_real_split_race_on_sim_ranks(tmp_path, capsys):
    from tpu_perf_torch.report import aggregate, interference_matrix

    rows = run_contend(Options(op="ppermute", buff_sz=4096, iters=2,
                               num_runs=3, load="split:2", device="cpu",
                               sim_ranks=8))
    idle = [r for r in rows if not r.load]
    loaded = [r for r in rows if r.load == "split:2"]
    assert len(idle) == len(loaded) == 3
    assert all(r.lat_us > 0 and r.stream == 0 for r in rows)
    (cell,) = interference_matrix(aggregate(rows))
    assert cell.load == "split:2" and cell.slowdown > 0
    assert cli.main(["contend", "--op", "ppermute", "--split", "2", "-b",
                     "4K", "-i", "2", "-r", "3", "--device", "cpu"]) == 0
    assert "under split:2: slowdown" in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--split", "1"], "K >= 2"),
    (["--split", "2", "--load", "hbm_stream"], "exactly one load shape"),
    (["--split", "2", "--op", "allreduce"], "slices a ppermute payload"),
])
def test_the_cli_refuses_as_jaxs(argv, match, capsys):
    argv = ["contend", "--device", "cpu", "-b", "4K", "--op", "ppermute",
            *argv]
    assert cli.main(argv) == 2
    assert match in capsys.readouterr().err
