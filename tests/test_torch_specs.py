"""The port's logical sharding specs and step-builder shapes
(``models/*.param_specs`` / ``cache_specs``, ``dit.engine_state_specs``,
``optim.adamw_state_specs``, ``launch/specs``, the builders' ``in_shapes``
of ``launch/steps``) against the JAX reference.  No world is needed: the
builders read only a mesh's axis names and sizes, so a stand-in mesh of
shape (1, 1) serves here, beside the reference's 1-device CPU ``Mesh``.

  * ``param_specs`` equals the reference's exactly for all twelve archs,
    smoke and published, and each spec has the ``ndim`` of the tensor at
    its path in ``init_params(cfg, None, "meta")``;
  * ``cache_specs`` likewise for the LM families, against ``init_cache``;
  * ``engine_state_specs``: ``(None, *port) == reference`` field for field
    over cache mode x kv buckets {1, 3} x mesh_sp {1, 2}, and each spec
    matches one layer's ``init_engine_states`` on ``meta``;
  * ``adamw_state_specs`` and the three logical batch specs equal the
    reference's; the shape stand-ins keep its shapes and dtypes;
  * every builder's ``in_shapes`` equal the reference builder's
    ``ShapeDtypeStruct`` shapes and dtypes, one arch per family;
  * ``named_sharding_tree`` over every spec tree raises for none of the
    twelve archs under ``rules_for`` of every shape.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed.sharding import DEFAULT_RULES, named_sharding_tree
from repro_torch.launch import specs as S
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import rules_for
from repro_torch.models import dit
from repro_torch.models.registry import LM_FAMILIES, get_model
from repro_torch.optim.optimizer import AdamWConfig, adamw_state_specs
from repro_torch.tree import tree_flatten

# One arch a family for the builders' shapes.
FAMILY_ARCHS = ("flux-mmdit", "gemma3-1b", "granite-moe-3b-a800m", "mamba2-370m",
                "recurrentgemma-2b", "whisper-large-v3", "llama-3.2-vision-11b")
LM_ARCHS = tuple(a for a in ARCH_IDS if get_smoke(a).family in LM_FAMILIES)
BATCH_SPECS = ("train_batch_logical", "prefill_batch_logical", "dit_inputs_logical")


class _Mesh:
    """What the builders read of a ``DeviceMesh``: its axis names and
    sizes."""

    def __init__(self, names=("data", "model")):
        self.mesh_dim_names = names
        self.ndim = len(names)

    def size(self, i: int) -> int:
        return 1


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _pick(arch, published):
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.registry import get_smoke as j_get_smoke
    return (get_config(arch), j_get_config(arch)) if published else \
        (get_smoke(arch), j_get_smoke(arch))


def _match_ndim(specs, tensors):
    """``specs`` and ``tensors`` leaf for leaf, each spec one entry a dim."""
    s_leaves, s_def = tree_flatten(specs, is_leaf=_is_spec)
    t_leaves, t_def = tree_flatten(tensors)
    assert str(s_def) == str(t_def)
    for s, t in zip(s_leaves, t_leaves):
        assert len(s) == t.ndim and t.is_meta, (s, tuple(t.shape))


@pytest.mark.parametrize("published", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, published):
    from repro.models.registry import get_model as j_get_model
    cfg, jcfg = _pick(arch, published)
    got = get_model(cfg).param_specs()
    assert got == j_get_model(jcfg).param_specs()
    _match_ndim(got, get_model(cfg).init_params(None, "meta"))


@pytest.mark.parametrize("published", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_match_the_reference(arch, published):
    from repro.models.registry import get_model as j_get_model
    cfg, jcfg = _pick(arch, published)
    got = get_model(cfg).cache_specs()
    assert got == j_get_model(jcfg).cache_specs()
    _match_ndim(got, get_model(cfg).init_cache(2, 64, device="meta"))


def _state_fields(st) -> dict:
    return {"s_c": st.s_c, "s_s": st.s_s, "taylor.derivs": st.taylor.derivs,
            "taylor.n_updates": st.taylor.n_updates, "k_since": st.k_since,
            **{f"plan.{f}": getattr(st.plan, f) for f in st.plan._fields}}


@pytest.mark.parametrize("cache_mode", ["bias", "o_cache"])
@pytest.mark.parametrize("kv_buckets", [1, 3])
@pytest.mark.parametrize("mesh_sp", [1, 2])
def test_engine_state_specs_drop_the_reference_layer_entry(cache_mode, kv_buckets, mesh_sp):
    from repro.configs.registry import get_smoke as j_get_smoke
    from repro.core.engine import EngineConfig as JEngineConfig
    from repro.models import dit as jdit
    from repro_torch.core.engine import EngineConfig
    kw = dict(cache_mode=cache_mode, kv_buckets=kv_buckets, mesh_sp=mesh_sp)
    got = _state_fields(dit.engine_state_specs(get_smoke("flux-mmdit"), EngineConfig(**kw)))
    want = _state_fields(jdit.engine_state_specs(j_get_smoke("flux-mmdit"), JEngineConfig(**kw)))
    assert got.keys() == want.keys()
    for name, spec in got.items():
        assert (spec is None) == (want[name] is None), name
        if spec is not None:
            assert (None, *spec) == want[name], name
    # One layer's state, as init_engine_states builds it on meta.
    cfg = get_smoke("flux-mmdit")
    state = _state_fields(dit.init_engine_states(cfg, EngineConfig(**kw), 2, 128, "meta")[0])
    for name, t in state.items():
        if isinstance(t, torch.Tensor):
            assert got[name] is not None and len(got[name]) == t.ndim, name
        elif t is None:
            assert got[name] is None, name
        else:                                    # the host-int counters
            assert got[name] == (), name


def test_adamw_state_specs_match_the_reference():
    from repro.optim.optimizer import adamw_state_specs as j_adamw_state_specs
    for arch in ("flux-mmdit", "gemma3-1b", "granite-moe-3b-a800m"):
        p = get_model(get_config(arch)).param_specs()
        got = adamw_state_specs(p)
        assert got == j_adamw_state_specs(p)
        assert got["mu"] == got["nu"] == p and got["step"] == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_the_reference(arch):
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.launch import specs as JS
    cfg, jcfg = _pick(arch, False)
    for name in BATCH_SPECS:
        assert getattr(S, name)(cfg) == getattr(JS, name)(jcfg), name
    shape = ShapeSpec("s", 96, 4, "train")
    for name in ("train_batch", "prefill_batch", "dit_inputs"):
        got = getattr(S, name)(cfg, shape)
        want = getattr(JS, name)(jcfg, JShapeSpec("s", 96, 4, "train"))
        _same_shapes(got, want)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _same_shapes(got, want):
    """A tree of meta tensors against the reference's ShapeDtypeStructs."""
    import jax
    g_leaves, g_def = tree_flatten(got)
    w_leaves, w_def = jax.tree.flatten(want)
    assert str(g_def) == str(w_def)
    for g, w in zip(g_leaves, w_leaves):
        assert g.is_meta
        assert (tuple(g.shape), _dtype_name(g.dtype)) == (tuple(w.shape), _dtype_name(w.dtype))


def _same_states(got: list, want, n_layers: int):
    """The port's per-layer states against the reference's stacked one."""
    assert len(got) == n_layers
    w = _state_fields(want)
    for st in got:
        for name, t in _state_fields(st).items():
            if isinstance(t, torch.Tensor):
                assert t.is_meta and tuple(t.shape) == tuple(w[name].shape[1:]), name
                assert _dtype_name(t.dtype) == _dtype_name(w[name].dtype), name
            elif t is None:
                assert w[name] is None, name
            else:                                # host ints here, (L,) arrays there
                assert tuple(w[name].shape) == (n_layers,), name


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_builder_in_shapes_match_the_reference(arch):
    import jax
    from jax.sharding import Mesh
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.distributed.sharding import DEFAULT_RULES as J_DEFAULT_RULES
    from repro.launch import steps as JST
    cfg, jcfg = _pick(arch, False)
    jmesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("data", "model"))
    mesh = _Mesh()
    seq = 128 if cfg.family == "dit" else 32
    train = (ShapeSpec("t", seq, 4, "train"), JShapeSpec("t", seq, 4, "train"))
    got = ST.build_train_step(cfg, train[0], mesh, DEFAULT_RULES)[1]
    want = JST.build_train_step(jcfg, train[1], jmesh, J_DEFAULT_RULES)[1]
    for g, w in zip(got, want):
        _same_shapes(g, w)
    if cfg.family == "dit":
        shape = (ShapeSpec("d", seq, 2, "serve"), JShapeSpec("d", seq, 2, "serve"))
        for mode in ("update", "dispatch"):
            g = ST.build_dit_step(cfg, shape[0], mesh, DEFAULT_RULES, mode=mode)[1]
            w = JST.build_dit_step(jcfg, shape[1], jmesh, J_DEFAULT_RULES, mode=mode)[1]
            _same_shapes(g[0], w[0])
            _same_states(g[1], w[1], cfg.n_layers)
            _same_shapes(g[2], w[2])
        return
    pre = (ShapeSpec("p", seq, 4, "prefill"), JShapeSpec("p", seq, 4, "prefill"))
    for g, w in zip(ST.build_prefill_step(cfg, pre[0], mesh, DEFAULT_RULES)[1],
                    JST.build_prefill_step(jcfg, pre[1], jmesh, J_DEFAULT_RULES)[1]):
        _same_shapes(g, w)
    dec = (ShapeSpec("d", 64, 4, "decode"), JShapeSpec("d", 64, 4, "decode"))
    for g, w in zip(ST.build_decode_step(cfg, dec[0], mesh, DEFAULT_RULES)[1],
                    JST.build_decode_step(jcfg, dec[1], jmesh, J_DEFAULT_RULES)[1]):
        _same_shapes(g, w)


def test_adamw_init_from_shapes_and_eval_shape_tree():
    import jax
    from repro.launch.steps import adamw_init_from_shapes as j_init
    from repro.models.registry import get_model as j_get_model
    from repro.configs.registry import get_smoke as j_get_smoke
    shapes = get_model(get_smoke("gemma3-1b")).init_params(None, "meta")
    j_shapes = jax.eval_shape(lambda: j_get_model(j_get_smoke("gemma3-1b")).init_params(
        jax.random.PRNGKey(0)))
    for cfg in (AdamWConfig(), AdamWConfig(moment_dtype="bfloat16")):
        _same_shapes(ST.adamw_init_from_shapes(shapes, cfg), jax.eval_shape(
            lambda: j_init(j_shapes, cfg)))
    out = ST.eval_shape_tree(lambda a, b: {"y": a @ b}, torch.empty((3, 4), device="meta"),
                             torch.empty((4, 5), device="meta"))
    assert out["y"].is_meta and tuple(out["y"].shape) == (3, 5)
    with pytest.raises(ValueError, match="meta"):
        ST.eval_shape_tree(lambda a: a, torch.zeros(2))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_named_sharding_tree_takes_every_spec_tree(multi_pod):
    mesh = _Mesh(("pod", "data", "model") if multi_pod else ("data", "model"))
    for arch, shape in itertools.product(ARCH_IDS, SHAPES.values()):
        cfg = get_config(arch)
        rules = rules_for(cfg, shape, multi_pod=multi_pod)
        model = get_model(cfg)
        trees = [model.param_specs(), adamw_state_specs(model.param_specs()),
                 *(getattr(S, name)(cfg) for name in BATCH_SPECS)]
        if cfg.family in LM_FAMILIES:
            trees.append(model.cache_specs())
        else:
            ecfg = ST.default_dit_engine_config()
            trees.append(ST._state_tree(dit.engine_state_specs(cfg, ecfg)))
            trees.append(ST._state_tree(dit.engine_state_specs(
                cfg, dataclasses.replace(ecfg, kv_buckets=3, mesh_sp=2))))
        for tree in trees:
            pl = named_sharding_tree(tree, mesh, rules)
            assert len(tree_flatten(pl, is_leaf=ST._is_pl)[0]) == \
                len(tree_flatten(tree, is_leaf=_is_spec)[0])
