"""The port's launchers (``repro_torch.launch.shapes``, ``mesh``,
``sharding``, ``specs``) held against ``repro.launch`` exactly, for all
ten presets: the input shapes, the long-context variant and the cache
capacity; the sharding rules' cases of ``tests/test_launch.py``; the
parameter spec trees in the training layout on both production meshes
and in the serving FSDP layout (the reference's ``PartitionSpec`` read
as a tuple); the cache spec trees of every plan; the abstract leaves'
shapes and dtypes at full width, node-stacked too; and ``input_specs``'
kinds, configurations, notes and spec trees on every shape and mesh.
Plain equality throughout.  No test imports ``repro.launch.dryrun``
(it sets ``XLA_FLAGS`` when imported).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS as R_ARCH_IDS  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import shapes as rshapes  # noqa: E402
from repro.launch import sharding as rsharding  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.utils.trees import tree_leaves_with_path  # noqa: E402

SHAPE_NAMES = tuple(rshapes.SHAPES)
MESHES = ("single", "multi")


def _norm(x):
    """A spec tree of either package as plain data: a ``PartitionSpec``
    as its tuple, a NamedTuple as its type name and fields, dicts and
    lists as they are; the port's specs are tuples already."""
    if isinstance(x, P):
        return tuple(x)
    if hasattr(x, "_fields"):
        return (type(x).__name__,
                {f: _norm(getattr(x, f)) for f in x._fields})
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _ref_spec_dict(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda s: isinstance(s, P))[0]}


def _port_spec_dict(params, specs):
    """path → spec, walking the port's spec tree beside its parameters
    (a spec is a tuple, so the parameter tree gives the structure)."""
    def at(tree, path):
        for k in path.split("/"):
            tree = tree[k if isinstance(tree, dict) else int(k)]
        return tree
    return {path: at(specs, path)
            for path, _ in tree_leaves_with_path(params)}


class _FakeMesh:
    """The reference's production mesh as far as ``input_specs`` reads
    it (``.shape``), with no devices."""

    def __init__(self, multi):
        self.shape = dict(tmesh.make_production_mesh(multi_pod=multi).shape)


# ------------------------------------------------------------- shapes

def test_arch_ids_match():
    assert ARCH_IDS == R_ARCH_IDS


def test_shapes_table_equals_reference():
    assert list(tshapes.SHAPES) == list(rshapes.SHAPES)
    for name, s in rshapes.SHAPES.items():
        t = tshapes.get_shape(name)
        assert (t.name, t.seq_len, t.global_batch, t.kind) == \
            (s.name, s.seq_len, s.global_batch, s.kind)
    assert tshapes.LONG_CTX_WINDOW == rshapes.LONG_CTX_WINDOW
    with pytest.raises(KeyError):
        tshapes.get_shape("train_1m")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_variant_capacity_admissible_equal_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    v, note = tshapes.long_ctx_variant(cfg)
    rv, rnote = rshapes.long_ctx_variant(rcfg)
    assert (v.name, v.sliding_window, note) == \
        (rv.name, rv.sliding_window, rnote)
    assert (v is cfg) == (rv is rcfg)
    for name in SHAPE_NAMES:
        s, rs = tshapes.get_shape(name), rshapes.get_shape(name)
        assert tshapes.admissible(cfg, s) == rshapes.admissible(rcfg, rs)
        for c, rc in ((cfg, rcfg), (v, rv)):
            assert tshapes.cache_capacity(c, s) == \
                rshapes.cache_capacity(rc, rs)


# ------------------------------------------------------------- mesh

def test_production_meshes_equal_reference_layouts():
    for multi, shape in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.shape == shape and list(m.shape) == list(shape)
        assert tmesh.n_chips(m) == (512 if multi else 256)
        assert tmesh.node_axes(m) == (("pod", "data") if multi
                                      else ("data",))
        assert tmesh.n_nodes(m) == (32 if multi else 16)
        # the reference's helpers read the same description the same way
        assert rmesh.n_chips(m) == tmesh.n_chips(m)
        assert rmesh.node_axes(m) == tmesh.node_axes(m)


def test_h100_constants_and_host_mesh():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 450e9
    assert tmesh.HBM_BYTES == 80e9
    host = tmesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1} and host.device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()


# ------------------------------------------------------------- sharding
# the cases of tests/test_launch.py, through the port

def test_col_row_rules():
    f = tsharding.param_spec_for
    assert f("seg0/mixer/wq/w", (52, 6144, 6144), 16) == \
        (None, None, "model")
    assert f("seg0/mixer/wo/w", (52, 6144, 6144), 16) == \
        (None, "model", None)
    assert f("seg0/ffn/down/w", (40, 22528, 8192), 16) == \
        (None, "model", None)


def test_expert_and_embed_rules():
    f = tsharding.param_spec_for
    assert f("seg1/ffn/experts/gate", (58, 256, 7168, 2048), 16) == \
        (None, "model", None, None)
    assert f("embed/table", (129280, 7168), 16) == ("model", None)
    # mamba2 vocab 50280 % 16 ≠ 0 → falls back to sharding d_model
    assert f("embed/table", (50280, 768), 16) == (None, "model")


def test_indivisible_col_falls_back_to_row():
    f = tsharding.param_spec_for
    assert f("seg0/mixer/in_proj/w", (24, 768, 3352), 16) == \
        (None, "model", None)
    assert f("seg0/mixer/in_proj/w", (78, 3584, 14576), 16) == \
        (None, None, "model")


def test_norms_replicated():
    spec = tsharding.param_spec_for("seg0/norm1/scale", (52, 6144), 16)
    assert all(e is None for e in spec)


def test_node_axis_lead():
    s = tsharding.param_spec_for("seg0/mixer/wq/w", (16, 52, 6144, 6144),
                                 16, lead=("pod", "data"))
    assert s == (("pod", "data"), None, None, "model")
    # a one-axis lead is the axis name, as a PartitionSpec keeps it
    s = tsharding.param_spec_for("seg0/mixer/wq/w", (16, 52, 6144, 6144),
                                 16, lead=("data",))
    assert s == tuple(P(("data",), None, None, "model"))


def test_fsdp_serving_layout():
    params = tspecs.abstract_params(get_config("deepseek-v3-671b"))
    specs = tsharding.param_specs(params, lead=None, model_size=16,
                                  fsdp_axes=("data",), fsdp_size=16)
    flat = _port_spec_dict(params, specs)
    experts = {p: s for p, s in flat.items() if "experts" in p}
    assert experts
    for path, spec in experts.items():
        names = [a for e in spec if e
                 for a in (e if isinstance(e, tuple) else (e,))]
        assert "model" in names and "data" in names, (path, spec)


def test_local_shape():
    m = tmesh.make_production_mesh(multi_pod=True)
    assert tsharding.local_shape((32, 4096, 1024), (("pod", "data"), None,
                                                    "model"), m) == \
        (1, 4096, 64)
    assert tsharding.local_shape((10, 7), (None, "model"), m) == (10, 1)
    assert tsharding.local_shape((), (), m) == ()
    t = torch.empty((32, 64), dtype=torch.bfloat16, device="meta")
    assert tsharding.local_bytes(t, ("data", "model"), m) == 2 * 4 * 2


# ------------------------------------------------ spec trees against repro

def _layouts(multi):
    lead = ("pod", "data") if multi else ("data",)
    nodes = 32 if multi else 16
    return lead, nodes


@pytest.mark.parametrize("multi", [False, True], ids=MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, multi):
    """The training layout (node-stacked, lead on the node axes) and the
    serving FSDP layout, leaf for leaf."""
    lead, nodes = _layouts(multi)
    cfg, rcfg = get_config(arch), rget(arch)
    params = tspecs.abstract_params(cfg, nodes)
    ref = _ref_spec_dict(rsharding.param_specs(
        rspecs.abstract_params(rcfg, nodes), lead=lead, model_size=16))
    assert _port_spec_dict(params, tsharding.param_specs(
        params, lead=lead, model_size=16)) == ref
    serve = tspecs.abstract_params(cfg)
    ref = _ref_spec_dict(rsharding.param_specs(
        rspecs.abstract_params(rcfg), lead=None, model_size=16,
        fsdp_axes=lead, fsdp_size=nodes))
    assert _port_spec_dict(serve, tsharding.param_specs(
        serve, lead=None, model_size=16, fsdp_axes=lead,
        fsdp_size=nodes)) == ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    state = init_cache(cfg.smoke(), batch=2, capacity=4, device="meta")
    for batch_axes in (("data",), ("pod", "data"), None):
        for heads, slots in ((True, False), (False, False), (False, True),
                             (True, True)):
            got = tsharding.cache_specs(state, batch_axes, cfg,
                                        shard_heads=heads, shard_slots=slots)
            want = rsharding.cache_specs(None, batch_axes, rcfg,
                                         shard_heads=heads,
                                         shard_slots=slots)
            assert _norm(got) == _norm(want), (batch_axes, heads, slots)


def test_cache_specs_structural():
    cfg = get_config("zamba2-7b").smoke()
    state = init_cache(cfg, batch=4, capacity=8, device="meta")
    specs = tsharding.cache_specs(state, ("data",), cfg)
    assert isinstance(specs.shared_caches, KVCache)
    assert specs.pos == ()
    assert specs.shared_caches.k == (None, "data", None, "model", None)


# ------------------------------------------------------------- specs

def _leaf_dict(params):
    return {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in tree_leaves_with_path(params)}


def _ref_leaf_dict(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    for nodes in (None, 16):
        got = tspecs.abstract_params(cfg, nodes)
        assert all(t.is_meta for _, t in tree_leaves_with_path(got))
        assert _leaf_dict(got) == _ref_leaf_dict(
            rspecs.abstract_params(rcfg, nodes))


def test_abstract_params_no_allocation():
    p = tspecs.abstract_params(get_config("deepseek-v3-671b"), n_nodes=16)
    leaves = [t for _, t in tree_leaves_with_path(p)]
    assert all(t.is_meta and t.shape[0] == 16 for t in leaves)
    total = sum(t.numel() for t in leaves) / 16
    assert 6e11 < total < 8e11                  # ≈ 671B a node replica


def test_batch_struct_vlm_splits_seq():
    cfg = get_config("llava-next-mistral-7b")
    b = tspecs.batch_struct(cfg, 4, 4096)
    assert b["tokens"].shape == (4, 4096 - cfg.vis_tokens)
    assert b["tokens"].dtype == torch.int64    # the reference's int32
    assert b["vis_embed"].shape == (4, cfg.vis_tokens, cfg.d_model)
    assert b["vis_embed"].dtype == torch.bfloat16
    rb = rspecs.batch_struct(rget("llava-next-mistral-7b"), 4, 4096, 2)
    tb = tspecs.batch_struct(cfg, 4, 4096, 2)
    assert {k: tuple(v.shape) for k, v in tb.items()} == \
        {k: tuple(v.shape) for k, v in rb.items()}


@pytest.fixture(scope="module")
def ref_input_specs():
    """The reference's ``input_specs`` with ``NamedSharding`` left out
    (its ``_shardings`` and ``NamedSharding`` return the spec tree as it
    is), so it runs on a mesh description with no devices."""
    mp = pytest.MonkeyPatch()
    mp.setattr(rspecs, "_shardings", lambda spec_tree, mesh: spec_tree)
    mp.setattr(rspecs, "NamedSharding", lambda mesh, spec: spec)
    yield rspecs.input_specs
    mp.undo()


@pytest.mark.parametrize("multi", [False, True], ids=MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(ref_input_specs, arch, multi):
    """Every shape on ``arch``: the kind, the configuration run (the
    long-context variant), the note word for word, and every spec tree
    — training state and batch, serving parameters, batch, cache and
    tokens."""
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    for name in SHAPE_NAMES:
        got = tspecs.input_specs(get_config(arch), name, mesh)
        want = ref_input_specs(rget(arch), name, _FakeMesh(multi))
        assert (got.kind, got.cfg.name, got.note) == \
            (want.kind, want.cfg.name, want.note), name
        assert dataclasses.asdict(got.cfg) == \
            dataclasses.asdict(want.cfg), name
        for g, w in zip(got.in_shardings, want.in_shardings, strict=True):
            assert _norm(g) == _norm(w), name


def test_input_specs_train_args_meta_and_int64():
    spec = tspecs.input_specs(get_config("qwen3-1.7b"), "train_4k",
                              tmesh.make_production_mesh())
    state, batch = spec.args
    assert all(t.is_meta for _, t in tree_leaves_with_path(state.params))
    assert batch["tokens"].shape == (16, 16, 4096)
    assert batch["tokens"].dtype == torch.int64
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    # n_nodes: several replicas on the devices of a small mesh
    host = tmesh.make_host_mesh("cpu")
    spec = tspecs.input_specs(get_config("qwen3-1.7b"),
                              tshapes.InputShape("t", 1024, 8, "train"),
                              host, n_nodes=4)
    assert spec.args[1]["tokens"].shape == (4, 2, 1024)
    with pytest.raises(ValueError, match="does not split"):
        tspecs.input_specs(get_config("qwen3-1.7b"),
                           tshapes.InputShape("t", 64, 6, "train"), host,
                           n_nodes=4)
