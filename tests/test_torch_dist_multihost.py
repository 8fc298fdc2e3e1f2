"""Multi-process set-up of the port (h2gcn_tpu_torch.parallel.multihost),
in one process: the twins of tests/test_multihost.py. ``initialize`` is a
no-op without a world to join and when a world is joined, checks its
arguments, and joins from explicit arguments; the node ranges are this
rank's stripe, checked for every rank of a mesh by patching the rank and
the world size."""

import pytest
import torch.distributed as dist

from h2gcn_tpu_torch.parallel import multihost


@pytest.fixture
def no_env(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)


def test_initialize_single_process_is_safe_and_idempotent(no_env, capsys):
    multihost.initialize()
    multihost.initialize()
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert out.count("[multihost] single-process mode") == 2


def test_initialize_argument_validation(no_env):
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=4)
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(process_id=1)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize(coordinator_address="localhost:1")
    with pytest.raises(ValueError, match="one device"):
        multihost.initialize(coordinator_address="localhost:1",
                             num_processes=1, process_id=0,
                             local_device_ids=[0, 1])


@pytest.fixture
def joins(monkeypatch):
    """The calls ``initialize`` makes to join a world, recorded."""
    calls = []
    monkeypatch.setattr(multihost, "init_group",
                        lambda *a: calls.append(a))
    return calls


def test_initialize_joins_from_arguments_or_torchrun(no_env, monkeypatch,
                                                     joins):
    multihost.initialize(coordinator_address="10.0.0.1:29500",
                         num_processes=4, process_id=3,
                         local_device_ids=[1], device_type="cuda")
    env = dict(WORLD_SIZE="8", RANK="5", MASTER_ADDR="node0",
               MASTER_PORT="29500")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    multihost.initialize(device_type="cpu")
    assert joins == [("tcp://10.0.0.1:29500", 4, 3, "cuda", 1),
                     ("env://", 8, 5, "cpu", None)]


def test_initialize_is_a_no_op_in_a_joined_world(no_env, tmp_path, joins):
    from h2gcn_tpu_torch.parallel.mesh import init_group

    mesh = init_group(f"file://{tmp_path / 'rendezvous'}", 1, 0, "cpu")
    try:
        assert (mesh.rank, mesh.size) == (0, 1)
        multihost.initialize(coordinator_address="localhost:1",
                             num_processes=2, process_id=1)
        assert joins == []
        assert multihost.host_local_node_range(12) == (0, 12)
    finally:
        dist.destroy_process_group()


def test_host_local_node_range_single_process():
    assert not dist.is_initialized()
    assert multihost.host_local_node_range(40) == (0, 40)


def test_host_local_node_range_rank_major(monkeypatch):
    """Eight ranks over an 8-way mesh: contiguous stripes in rank order
    that partition [0, n_pad)."""
    monkeypatch.setattr(multihost, "process_count", lambda: 8)
    ranges = []
    for rank in range(8):
        monkeypatch.setattr(multihost, "process_index", lambda r=rank: r)
        ranges.append(multihost.host_local_node_range(40))
    assert ranges == [(5 * r, 5 * (r + 1)) for r in range(8)]


def test_host_local_node_range_uneven_mesh(monkeypatch):
    """A mesh smaller than the world: ranks past it get an empty range at
    its end."""
    monkeypatch.setattr(multihost, "process_index", lambda: 5)
    assert multihost.host_local_node_range(8, num_shards=4) == (8, 8)


def test_host_local_node_range_divisibility_guard():
    with pytest.raises(ValueError, match="not divisible"):
        multihost.host_local_node_range(7, num_shards=8)
