"""K10's two routes (ops/cuda_halo.py: ring_plan) on the CPU.

ring_plan reads pointers, shapes and strides only, so it runs on CPU
tensors: the view route for the blocks coll.shard_time gives (views of one
signal, one row stride, one spacing), the pointer table for any other ring.
The mesh paths' own calls are spied on to show they take the view route.
On CPU tensors ring_halo and ring_halo_table return the plain version; the
kernels on the card are tests/test_torch_cuda.py's, the comparison with
godsp_tpu's ring_halo_pallas tests/test_torch_parallel.py's.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from godsp_tpu_torch import default_device, parallel, set_default_device, spectral
from godsp_tpu_torch.ops import cuda_halo
from godsp_tpu_torch.parallel import _collectives as coll
from godsp_tpu_torch.parallel import streaming

CPU = torch.device("cpu")
HALO_CU = pathlib.Path(cuda_halo.__file__).resolve().parent.parent / "csrc" / "halo_kernel.cu"


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape, n_sp, halo, stride", [
    ((8 * 512,), 8, 96, 512),
    ((3, 4 * 256), 4, 128, 1024),
    ((2, 8 * 130), 8, 7, 1040),
], ids=["single_row", "batched_rows", "unaligned"])
def test_shard_time_views_take_the_view_route(shape, n_sp, halo, stride):
    x = _x(*shape)
    blocks = coll.shard_time(x, [CPU] * n_sp)
    plan = cuda_halo.ring_plan(blocks, halo)
    rows = 1 if len(shape) == 1 else shape[0]
    L = shape[-1] // n_sp
    assert plan.route == "view" and plan.rows == rows and plan.spacing == L
    if rows > 1:
        assert plan.stride == stride
    assert plan.vec == int(halo % 4 == 0 and L % 4 == 0 and stride % 4 == 0)


def test_a_streaming_chunk_takes_the_view_route():
    """The chunk + halo buffer of a stream: blocks carry the buffer's row
    stride (8 x 1000 + 512), not their own length."""
    ext = _x(2, 8 * 1000 + 512)
    blocks = coll.shard_time(ext[:, : 8 * 1000], [CPU] * 8)
    plan = cuda_halo.ring_plan(blocks, 512)
    assert plan == cuda_halo.RingPlan("view", 2, 1, 8 * 1000 + 512, 1000)


@pytest.mark.parametrize("case", ["reversed", "one_shard", "same_block", "65_shards"])
def test_view_route_edges(case):
    x = _x(65 * 64)
    blocks = {"reversed": lambda: list(x[: 4 * 64].chunk(4))[::-1],
              "one_shard": lambda: [x[:64]],
              "same_block": lambda: [x[:64]] * 3,
              "65_shards": lambda: list(x.chunk(65))}[case]()
    plan = cuda_halo.ring_plan(blocks, 16)
    assert plan.route == "view"
    assert plan.spacing == {"reversed": -64, "one_shard": 0, "same_block": 0, "65_shards": 64}[case]
    got = cuda_halo.ring_halo(blocks, 16)
    for g, w in zip(got, cuda_halo.ring_halo_plain(blocks, 16)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["separate_tensors", "ragged_spacing", "mixed_row_strides",
                                  "ragged_lengths", "two_signals"])
def test_other_rings_take_the_table_route(case):
    x, y = _x(4, 1000), _x(4, 1000, seed=1)
    blocks = {
        "separate_tensors": lambda: [_x(4, 64, seed=s) for s in range(4)],
        "ragged_spacing": lambda: [x[:, 0:64], x[:, 64:128], x[:, 130:194], x[:, 194:258]],
        "mixed_row_strides": lambda: [x[:, 0:64], x[:, 64:128], x[:, 128:192].contiguous()],
        "ragged_lengths": lambda: [x[:, 0:64], x[:, 64:160], x[:, 160:224]],
        "two_signals": lambda: [x[:, 0:64], y[:, 64:128]],
    }[case]()
    plan = cuda_halo.ring_plan(blocks, 16)
    assert plan.route == "table" and plan.rows == 4
    assert plan.strides == tuple(b.stride(0) for b in blocks)
    for fn in (cuda_halo.ring_halo, cuda_halo.ring_halo_table):
        for g, w in zip(fn(blocks, 16), cuda_halo.ring_halo_plain(blocks, 16)):
            assert torch.equal(g, w)


def test_ring_plan_errors():
    x = _x(4, 256)
    with pytest.raises(TypeError, match="float32"):
        cuda_halo.ring_plan(list(x.double().chunk(4, dim=-1)), 8)
    with pytest.raises(ValueError, match="halo"):
        cuda_halo.ring_plan(list(x.chunk(4, dim=-1)), 65)
    with pytest.raises(ValueError, match="no blocks"):
        cuda_halo.ring_plan([], 8)
    with pytest.raises(ValueError, match="at most 64"):
        cuda_halo.ring_plan([_x(8, seed=s) for s in range(65)], 4)
    with pytest.raises(ValueError, match="leading"):
        cuda_halo.ring_halo_table([_x(2, 64), _x(3, 64)], 8)


def test_the_table_holds_as_many_shards_as_the_kernel():
    m = re.search(r"constexpr int kMaxShards = (\d+);", HALO_CU.read_text())
    assert m and int(m.group(1)) == cuda_halo._MAX_SHARDS


@pytest.mark.parametrize("entry", ["pwelch_sharded", "stream_pwelch"])
def test_the_mesh_paths_give_k10_view_rings(monkeypatch, entry):
    """The "pallas" halo route hands ring_halo shard_time's views: every
    ring it builds takes the view route."""
    routes = []
    real = cuda_halo.ring_halo

    def spy(blocks, halo):
        routes.append(cuda_halo.ring_plan(blocks, halo).route)
        return real(blocks, halo)

    monkeypatch.setattr(cuda_halo, "ring_halo", spy)
    mesh = parallel.make_mesh(parallel.MeshConfig(dp=1, sp=8), devices=["cpu"] * 8)
    x = _x(8 * 256 * 8)
    opts = spectral.PwelchOptions(nfft=256, noverlap=128)
    if entry == "pwelch_sharded":
        parallel.pwelch_sharded(x, 1.0, opts, mesh, halo_impl=("pallas", False))
    else:
        # float32, as on the card (a stream on the CPU works in float64)
        monkeypatch.setattr(streaming, "working_float", lambda device: torch.float32)
        monkeypatch.setattr(streaming, "np_float_for", lambda device: np.float32)
        blocks = (x[i: i + 4096].numpy() for i in range(0, x.shape[0], 4096))
        parallel.stream_pwelch(blocks, 1.0, opts, mesh=mesh, segs_per_chunk_shard=8,
                               halo_impl=("pallas", False))
    assert routes and set(routes) == {"view"}
