"""The port's local memory instruments against the JAX package, on the CPU:
``pl_hbm_copy``, ``pl_hbm_read`` and ``pl_hbm_write`` (plain versions of
the bulk-copy kernels against the Pallas kernels under the TPU
interpreter) and the library ops ``hbm_read``, ``hbm_write`` and
``hbm_triad`` (against their XLA bodies), on the same ``make_fill`` input
carried across with ``to_world``.

Tolerances: exact for the three ``pl_*`` ops (they move bytes) and for
every integer case (wrapping adds on both sides).  float32 rtol 1e-6:
both sides round each operation to the dtype, but the float32 mean of
``hbm_read`` sums in another order than XLA's.  bfloat16 rtol 8e-3, one
bfloat16 unit in the last place.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_perf.cli as jax_cli
import tpu_perf.ops.pallas_ring as jpr
import tpu_perf.schema as jschema
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.ops import payload_elems as jax_payload_elems
from tpu_perf.ops.collectives import FLOAT_ONLY_OPS as JAX_FLOAT_ONLY_OPS
from tpu_perf.parallel import make_mesh

import tpu_perf_torch.ops.pallas_ring as tpr
from tpu_perf_torch import cli, kernels
from tpu_perf_torch.ops.collectives import (
    DTYPES, FLOAT_ONLY_OPS, build_op, payload_elems, to_tensor,
)
from tpu_perf_torch.selftest import run_selftest
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")
RTOL = {"float32": 1e-6, "bfloat16": 8e-3, "int32": 0, "uint8": 0}
PL_OPS = ["pl_hbm_copy", "pl_hbm_read", "pl_hbm_write"]
LIBRARY_OPS = ["hbm_read", "hbm_write", "hbm_triad"]
LOCAL_OPS = PL_OPS + LIBRARY_OPS
#: a ragged size: neither a 4 KiB multiple nor a multiple of 16 bytes
RAGGED = 3 * 4096 + 8


def _compare(op, n, nbytes, iters, dtype):
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, nbytes, iters, dtype=dtype)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    pb = build_op(op, SimWorld(n, CPU), nbytes, iters, dtype=dtype)
    xt = to_tensor(to_world(x, n), dtype, CPU)
    # the state both sides compute on is the same, element for element
    assert torch.equal(xt, pb.example_input)
    got = from_world(pb.step(xt)).astype(np.float64)
    assert (pb.nbytes, pb.n_devices) == (jb.nbytes, jb.n_devices)
    rtol = 0 if op in PL_OPS else RTOL[dtype]
    np.testing.assert_allclose(got, want.astype(np.float64), rtol=rtol, atol=0)


#: the row-copy kernels' tile edges: one tile, one tile and an element,
#: and a size that is no multiple of 16 bytes (at n = 8 the rows start
#: 16-byte unaligned)
TILE_EDGES = ["tile", "tile+item", "unaligned"]


def tile_edge_nbytes(edge: str, itemsize: int) -> int:
    tile = tpr.ROW_COPY_TILE_BYTES
    return {"tile": tile, "tile+item": tile + itemsize,
            "unaligned": 2 * tile + 4}[edge]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize(
    "op,edge", [pytest.param(op, None, id=op) for op in LOCAL_OPS]
    + [pytest.param("pl_hbm_copy", edge, id=f"pl_hbm_copy-{edge}")
       for edge in TILE_EDGES])
def test_local_op_matches_jax(op, edge, n, iters, dtype, eight_devices):
    # the RAGGED size, or the copy at its kernel's tile edges
    nbytes = (RAGGED if edge is None
              else tile_edge_nbytes(edge, DTYPES[dtype].itemsize))
    if op in FLOAT_ONLY_OPS and dtype in ("int32", "uint8"):
        with pytest.raises(ValueError, match="float dtype"):
            build_op(op, SimWorld(n, CPU), nbytes, iters, dtype=dtype)
        return
    _compare(op, n, nbytes, iters, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("op", ["pl_hbm_read", "pl_hbm_write"])
def test_several_dma_blocks_and_a_rem_tail_match_jax(op, n, dtype,
                                                     eight_devices,
                                                     monkeypatch):
    # a small stream tile on both sides: 16 KiB rows hold several DMA
    # blocks and a partial tail (float32: 2 blocks of 1536 + 1024)
    monkeypatch.setattr(jpr, "_STREAM_TILE_ELEMS", 1536)
    monkeypatch.setattr(tpr, "_STREAM_TILE_ELEMS", 1536)
    itemsize = DTYPES[dtype].itemsize
    elems = 4 * 4096 // itemsize
    block = tpr.hbm_dma_block_elems(itemsize, elems)
    assert elems // block >= 2 and elems % block
    _compare(op, n, 4 * 4096 - 8, 2, dtype)


@pytest.mark.parametrize("nbytes", [1, 13, 4096, RAGGED, 11 * 4096 + 8,
                                    456131, 3 * 2**21 + 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_nbytes_match_jax_actual_nbytes(dtype, nbytes, eight_devices):
    for n in (1, 8):
        mesh = make_mesh(devices=jax.devices()[:n])
        for op in PL_OPS:
            _, jx, actual, jn = jpr.build_pallas_step(op, mesh, nbytes, 1,
                                                      dtype=dtype)
            _, elems, got = tpr.build_pallas_step(op, SimWorld(n, CPU),
                                                  nbytes, 1, dtype=dtype)
            assert (elems * n, got, n) == (jx.shape[0], actual, jn), op
        for op in LIBRARY_OPS:
            itemsize = DTYPES[dtype].itemsize
            assert (payload_elems(op, nbytes, n, itemsize)
                    == jax_payload_elems(op, nbytes, n, itemsize)), op


def test_pl_and_library_ops_share_curve_keys_at_4k_multiples():
    world = SimWorld(8, CPU)
    for pl_op, xla_op in (("pl_hbm_read", "hbm_read"),
                          ("pl_hbm_write", "hbm_write"),
                          ("pl_hbm_copy", "hbm_stream")):
        assert (build_op(pl_op, world, 11 * 4096, 1).nbytes
                == build_op(xla_op, world, 11 * 4096, 1).nbytes)
    # below the 4 KiB DMA tiling the single-sided sweeps round up
    assert build_op("pl_hbm_read", world, 4 * 1000 + 3, 1).nbytes == 4096
    assert build_op("pl_hbm_copy", world, 4 * 1000 + 3, 1).nbytes == 4004


def test_float_only_ops_are_the_jax_ones():
    assert set(FLOAT_ONLY_OPS) <= set(JAX_FLOAT_ONLY_OPS)
    assert "hbm_read" in FLOAT_ONLY_OPS


# --- the wrappers and their plain versions ------------------------------


def _ramp(shape, dtype=torch.float32):
    return torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape).to(dtype)


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_counts()
    x = _ramp((3, 64))
    assert torch.equal(tpr.hbm_copy(x), x) and tpr.hbm_copy(x) is not x
    assert tpr.hbm_read(x) is x
    tpr.hbm_write(x, 16)
    assert kernels.PLAIN_CALLS == {**dict.fromkeys(kernels.KERNELS, 0),
                                   "hbm_copy": 2, "hbm_read": 1,
                                   "hbm_write": 1}
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("row,block", [(64, 16), (70, 16), (16, 16), (5, 3)])
def test_hbm_write_plain_tiles_the_first_block(row, block, dtype):
    x = _ramp((4, row), dtype)
    out = tpr.hbm_write(x, block)
    reps = -(-row // block)
    want = np.tile(x.float().numpy()[:, :block], reps)[:, :row]
    np.testing.assert_array_equal(out.float().numpy(), want)


@pytest.mark.parametrize("wrapper", [
    lambda x: tpr.hbm_copy(x),
    lambda x: tpr.hbm_read(x),
    lambda x: tpr.hbm_write(x, 4),
])
def test_bulk_wrappers_refuse_other_devices(wrapper):
    with pytest.raises(ValueError):
        wrapper(torch.empty((4, 8), device="meta"))


@pytest.mark.parametrize("block", [0, -1, 9])
def test_hbm_write_refuses_a_block_outside_the_row(block):
    with pytest.raises(ValueError, match="block"):
        tpr.hbm_write(_ramp((2, 8)), block)


def test_bulk_alignment_check_names_the_rounding():
    tpr._check_bulk_aligned("hbm_read", 4096, 16)
    with pytest.raises(ValueError, match="4096 bytes"):
        tpr._check_bulk_aligned("hbm_read", 4100)


@pytest.mark.parametrize("op", LIBRARY_OPS)
def test_library_carries_update_in_place(op):
    # a copy per execution would add a full buffer copy to what the
    # instrument times: each body returns its input's storage
    built = build_op(op, SimWorld(2, CPU), 4096, 3)
    x = built.example_input
    assert built.step(x).data_ptr() == x.data_ptr()


def test_hbm_triad_leaves_the_second_half_alone():
    built = build_op("hbm_triad", SimWorld(2, CPU), 4 * 10, 2)
    x = built.example_input.clone()
    y = built.step(built.example_input.clone())
    assert torch.equal(y[:, 5:], x[:, 5:])
    assert not torch.equal(y[:, :5], x[:, :5])


# --- selftest models, CLI rows ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("n", [1, 8])
def test_selftest_models_pass_for_the_local_ops(n, dtype, monkeypatch):
    # several write blocks per row: the pl_hbm_write model must take the
    # block from the native itemsize, not from the float64 model array
    monkeypatch.setattr(tpr, "_STREAM_TILE_ELEMS", 256)
    results = run_selftest(SimWorld(n, CPU), ops=LOCAL_OPS,
                           nbytes=2 * 2 * 256 * 4 + 8, dtype=dtype, iters=2)
    want_skip = {"hbm_read"} if dtype == "uint8" else set()
    assert {r.op for r in results if r.status == "skip"} == want_skip, results
    assert all(r.status == "ok" for r in results if r.op not in want_skip)


def test_selftest_catches_a_wrong_write_block(monkeypatch):
    # the model is not vacuous: a kernel tiling a different block fails it
    monkeypatch.setattr(tpr, "_STREAM_TILE_ELEMS", 256)
    real = tpr.hbm_write
    monkeypatch.setattr(tpr, "hbm_write", lambda x, block: real(x, block // 2))
    (result,) = run_selftest(SimWorld(2, CPU), ops=["pl_hbm_write"],
                             nbytes=8192, iters=1)
    assert result.status == "fail"


def _csv_rows(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert lines[0] == jschema.RESULT_HEADER
    return [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]


@pytest.mark.parametrize("op", LOCAL_OPS)
def test_cli_rows_parse_and_match_the_jax_cli(op, eight_devices, capsys):
    flags = ["run", "--op", op, "-b", "4K", "-i", "1", "-r", "2"]
    assert cli.main(flags + ["--device", "cpu"]) == 0
    port = _csv_rows(capsys.readouterr().out)
    assert jax_cli.main(flags) == 0
    ref = _csv_rows(capsys.readouterr().out)
    assert [(r.op, r.nbytes, r.n_devices, r.iters, r.run_id) for r in port] \
        == [(r.op, r.nbytes, r.n_devices, r.iters, r.run_id) for r in ref]
    assert all(r.backend == "torch-sim" and r.busbw_gbps > 0 for r in port)


@pytest.mark.parametrize("op", LOCAL_OPS)
def test_one_rank_rows_measure_the_card_itself(op, capsys):
    assert cli.main(["run", "--op", op, "--sweep", "4K:16K", "-i", "2",
                     "--sim-ranks", "1", "--device", "cpu"]) == 0
    rows = _csv_rows(capsys.readouterr().out)
    assert [r.nbytes for r in rows] == [4096, 8192, 16384]
    assert {(r.backend, r.n_devices) for r in rows} == {("torch", 1)}


def test_ops_listing_marks_only_the_unported_kernels(capsys):
    assert cli.main(["ops"]) == 0
    listed = capsys.readouterr().out.splitlines()
    for op in PL_OPS + LIBRARY_OPS + ["pl_all_gather_bidir", "pl_all_to_all"]:
        assert op in listed
    # every kernel is ported: no line is marked
    assert not [ln for ln in listed if "not yet ported" in ln]
