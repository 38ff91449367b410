"""The port's sharding modules over ``torch.distributed``
(``repro_torch.distributed.{sharding, ctx, collective_matmul}``,
``repro_torch.runtime.elastic``, ``launch/mesh.rules_for`` and
``make_production_mesh``) against the JAX reference.

  * ``logical_to_physical`` equals the reference's ``PartitionSpec`` entry
    for entry over all five rule sets and a grid of logical specs;
  * ``rules_for`` equals the reference's field for field over the twelve
    archs × the four ``SHAPES`` × ``multi_pod``;
  * ``constrain`` outside a rules context is the identity;
  * in one spawned ``gloo`` world of 8 ranks, shared by every case:
    ``ag_matmul_overlapped`` within 1e-4 of ``jnp.einsum`` on the same
    numpy inputs; ``shrink_mesh`` takes (4, 2) to (2, 2), and its
    ``surviving=`` path keeps the reference's rank order; ``reshard_state``
    round trips bit for bit (``tests/test_distributed.py``'s elastic case),
    also on the two paths a ``gloo`` world of card tensors takes (staged
    through the host, and between the ranks of one host, whose moves of
    nested shards and partial sums equal DTensor's own); ``constrain`` inside a rules context redistributes a DTensor and leaves
    a plain tensor alone; ``make_production_mesh`` over the world on the
    CPU when asked, and raising by default where there is no card.

The spawned ranks run a module-level function of this file, which imports
neither JAX nor the reference at module level, so a rank imports torch
only.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import ctx as TC
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import rules_for, run_local_mesh

RULE_SETS = ("DEFAULT_RULES", "MULTIPOD_RULES", "MULTIPOD_ZERO_RULES", "SEQ_RULES",
             "MULTIPOD_SEQ_RULES")
LOGICAL = (None, "dp", "fsdp", "tp", "sp", "ep", "dp+sp", "fsdp+tp")
# The collective matmul's shapes (the reference's subprocess case).
CM = dict(b=2, s=32, d=16, f=24)
JOIN_S = 120


def _specs():
    """Every logical spec of one to three dims over ``LOGICAL``."""
    for n in (1, 2, 3):
        yield from itertools.product(LOGICAL, repeat=n)


@pytest.mark.parametrize("rules", RULE_SETS)
def test_logical_to_physical_matches_the_reference(rules):
    from repro.distributed import sharding as JS
    got_rules, want_rules = getattr(TS, rules), getattr(JS, rules)
    assert dataclasses.asdict(got_rules) == dataclasses.asdict(want_rules)
    for spec in _specs():
        got = TS.logical_to_physical(spec, got_rules)
        want = JS.logical_to_physical(spec, want_rules)
        assert isinstance(got, TS.PartitionSpec)
        assert tuple(got) == tuple(want), spec


def test_tree_logical_to_physical_matches_the_reference():
    from repro.distributed import sharding as JS
    tree = {"w": ("fsdp", "tp"), "b": ("tp",), "blocks": [("dp", None), ()],
            "scalar": ()}
    got = TS.tree_logical_to_physical(tree, TS.MULTIPOD_RULES)
    want = JS.tree_logical_to_physical(tree, JS.MULTIPOD_RULES)
    assert tuple(got["w"]) == tuple(want["w"]) == ("data", "model")
    assert tuple(got["blocks"][0]) == tuple(want["blocks"][0]) == (("pod", "data"), None)
    assert tuple(got["blocks"][1]) == tuple(want["blocks"][1]) == ()
    assert tuple(got["b"]) == tuple(want["b"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_for_matches_the_reference(multi_pod):
    from repro.configs.base import SHAPES as J_SHAPES
    from repro.configs.registry import get_config as j_get_config
    from repro.launch.mesh import rules_for as j_rules_for
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert len(ARCH_IDS) == 12
    for arch, shape in itertools.product(ARCH_IDS, SHAPES):
        got = rules_for(get_config(arch), SHAPES[shape], multi_pod=multi_pod)
        want = j_rules_for(j_get_config(arch), J_SHAPES[shape], multi_pod=multi_pod)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, shape)


def test_constrain_outside_a_context_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert TC.constrain(x, "dp", "tp") is x
    with TC.activation_rules(TS.DEFAULT_RULES):
        assert TC.constrain(x, "dp", "tp") is x          # a plain tensor has no layout
        with TC.activation_rules(None):
            assert TC.constrain(x, "dp", None) is x


def test_placements_and_named_sharding_tree_name_every_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:                                   # the attribute placements() reads
        mesh_dim_names = ("pod", "data", "model")

    pl = TS.placements(TS.PartitionSpec(("pod", "data"), None, "model"), Mesh())
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert TS.placements(TS.PartitionSpec(None, None), Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh axis 'seq'"):
        TS.placements(TS.PartitionSpec("seq"), Mesh())
    with pytest.raises(ValueError, match="two dims"):
        TS.placements(TS.PartitionSpec("data", "data"), Mesh())
    tree = TS.named_sharding_tree({"w": ("fsdp", "tp"), "blocks": [("dp", None)]}, Mesh(),
                                  TS.MULTIPOD_RULES)
    assert tree == {"w": [Replicate(), Shard(0), Shard(1)],
                    "blocks": [[Shard(0), Shard(0), Replicate()]]}


def _cm_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((CM["b"], CM["s"], CM["d"])).astype(np.float32),
            rng.standard_normal((CM["d"], CM["f"])).astype(np.float32))


def _names(placements) -> list:
    return [(type(p).__name__, getattr(p, "dim", None)) for p in placements]


def world_rank(rank: int) -> dict:
    """One rank of the world of 8: every case, this rank's results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from repro_torch.distributed.collective_matmul import ag_matmul_overlapped
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.elastic import reshard_state, shrink_mesh
    out = {}
    x, w = (torch.from_numpy(a) for a in _cm_inputs())
    s_loc = CM["s"] // dist.get_world_size()
    out["ag"] = ag_matmul_overlapped(x[:, rank * s_loc:(rank + 1) * s_loc], w)
    # A ring over a sub-group: the four ranks of one half.
    half = [dist.new_group(list(range(i, i + 4))) for i in (0, 4)][rank // 4]
    q = CM["s"] // 4
    out["ag_half"] = ag_matmul_overlapped(x[:, (rank % 4) * q:(rank % 4 + 1) * q], w, half)

    mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"))
    rules = TS.ShardingRules()
    state = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(8.0)}
    spec = {"w": ("fsdp", "tp"), "b": ("tp",)}
    sharded = reshard_state(state, spec, mesh, rules)
    out["sharded_local"] = {k: tuple(v.to_local().shape) for k, v in sharded.items()}
    out["sharded_placements"] = _names(sharded["w"].placements)
    small = shrink_mesh(mesh, drop_data_rows=1)
    out["small"] = small.mesh.tolist()
    moved = reshard_state(sharded, spec, small, rules)
    out["in_small"] = small.get_coordinate() is not None
    if out["in_small"]:
        out["round_trip"] = {k: bool(torch.equal(v.full_tensor(), state[k]))
                             for k, v in moved.items()}
        out["moved_local"] = tuple(moved["w"].to_local().shape)
    # The two paths that a gloo world of card tensors takes, here on CPU
    # tensors: staged through the host, and between the ranks of one host
    # (the peers' tensors mapped into each rank).  The same bits.
    nested = distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh, [Shard(0), Shard(0)])
    partial = DTensor.from_local(torch.full((4, 2), rank + 1.0), mesh, [Partial(), Replicate()])
    moves = ((nested, [Replicate(), Shard(0)]), (nested, [Shard(1), Replicate()]),
             (partial, [Shard(0), Replicate()]), (partial, [Replicate(), Replicate()]))
    own = [x.redistribute(mesh, pl).to_local() for x, pl in moves]
    # A mesh dim of one rank: sharded over it, a tensor is whole already.
    row = DeviceMesh("cpu", torch.arange(8).reshape(1, 8), mesh_dim_names=("data", "model"))
    one = distribute_tensor(torch.arange(64.0).reshape(8, 8), row, [Shard(0), Shard(1)])
    own_one = one.redistribute(row, [Replicate(), Replicate()]).to_local()
    staged, one_host = TS._staged, TS._one_host
    TS._staged = lambda m: True
    try:
        TS._one_host = lambda: False
        via_host = reshard_state(reshard_state(state, spec, mesh, rules), spec, small, rules)
        TS._one_host = lambda: True
        via_peers = reshard_state(reshard_state(state, spec, mesh, rules), spec, small, rules)
        out["peer_moves"] = [bool(torch.equal(TS.redistribute(x, pl).to_local(), want))
                             for (x, pl), want in zip(moves, own)]
        undo, undone = TS._undo_dim, []
        TS._undo_dim = lambda local, m, dim, p: undone.append(dim) or undo(local, m, dim, p)
        try:
            got = TS.redistribute(one, [Replicate(), Replicate()]).to_local()
        finally:
            TS._undo_dim = undo
        out["size1_move"] = (bool(torch.equal(got, own_one)), undone)
    finally:
        TS._staged, TS._one_host = staged, one_host
    if out["in_small"]:
        out["round_trip_via_host"] = {k: bool(torch.equal(v.full_tensor(), state[k]))
                                      for k, v in via_host.items()}
        out["round_trip_via_peers"] = {k: bool(torch.equal(v.full_tensor(), state[k]))
                                       for k, v in via_peers.items()}
    out["surviving"] = shrink_mesh(mesh, surviving=[0, 2, 3, 4, 5, 6, 7]).mesh.tolist()
    mesh3 = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                       mesh_dim_names=("pod", "data", "model"))
    small3 = shrink_mesh(mesh3, drop_data_rows=1)
    out["small3"] = (small3.mesh.tolist(), small3.mesh_dim_names)
    out["surviving3"] = shrink_mesh(mesh3, surviving=list(range(8))).mesh_dim_names

    dt = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh, [Replicate(), Replicate()])
    with TC.activation_rules(TS.DEFAULT_RULES):
        c = TC.constrain(dt, "dp", "tp")
    out["constrained"] = (_names(c.placements), tuple(c.to_local().shape),
                          bool(torch.equal(c.full_tensor(), dt.full_tensor())))
    out["outside"] = TC.constrain(dt, "dp", "tp") is dt
    prod = make_production_mesh(device_type="cpu")
    out["production"] = (prod.mesh.tolist(), prod.mesh_dim_names)
    out["default_mesh"] = None
    if not torch.cuda.is_available():
        try:
            make_production_mesh()
        except RuntimeError as e:
            out["default_mesh"] = str(e)
    return out


@pytest.fixture(scope="module")
def world():
    return run_local_mesh(world_rank, 4, 2, timeout=JOIN_S)


def test_ag_matmul_overlapped_matches_the_einsum(world):
    import jax.numpy as jnp
    x, w = _cm_inputs()
    want = np.asarray(jnp.einsum("bsd,df->bsf", x, w))
    for r in world:
        np.testing.assert_allclose(r["ag"].numpy(), want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["ag_half"].numpy(), want, rtol=0, atol=1e-4)
        assert r["ag"].shape == (CM["b"], CM["s"], CM["f"])


def test_shrink_mesh_keeps_a_power_of_two_of_data_rows(world):
    for r in world:
        assert r["small"] == [[0, 1], [2, 3]]
        # The reference keeps the survivors in mesh order and cuts the list
        # to whole rows: 7 survivors of 2 columns -> 2 rows.
        assert r["surviving"] == [[0, 2], [3, 4]]
        assert r["small3"] == ([[[0, 1]], [[4, 5]]], ("pod", "data", "model"))
        assert r["surviving3"] == ("data", "model")
    assert [r["in_small"] for r in world] == [True] * 4 + [False] * 4


def test_reshard_state_round_trips_bit_for_bit(world):
    for r in world:
        assert r["sharded_local"] == {"w": (2, 4), "b": (4,)}
        assert r["sharded_placements"] == [("Shard", 0), ("Shard", 1)]
        if r["in_small"]:
            assert r["round_trip"] == {"w": True, "b": True}
            assert r["round_trip_via_host"] == {"w": True, "b": True}
            assert r["round_trip_via_peers"] == {"w": True, "b": True}
            assert r["moved_local"] == (4, 4)


def test_peer_moves_equal_dtensors_own(world):
    """Moves between the ranks of one host (nested shards made whole
    innermost first, partial sums in mesh order) give DTensor's own
    results; a mesh dim of one rank moves nothing."""
    for r in world:
        assert r["peer_moves"] == [True] * 4
        assert r["size1_move"] == (True, [1])


def test_constrain_redistributes_a_dtensor_in_a_context(world):
    for r in world:
        assert r["constrained"] == ([("Shard", 0), ("Shard", 1)], (1, 2), True)
        assert r["outside"]
        assert r["production"] == ([list(range(8))], ("data", "model"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host without a card")
def test_production_mesh_is_the_cards_by_default(world):
    """No fallback to the CPU: without a card the default mesh raises."""
    for r in world:
        assert r["default_mesh"] is not None and "no CUDA device" in r["default_mesh"]
