"""The port's checkpoint store (``repro_torch.checkpoint``): every case
of tests/test_checkpoint.py on torch tensors — tree round trips (dict /
list / NamedTuple paths, dtype preservation, missing-leaf KeyError),
shard chunking, and the crash-safety contract (stage into ``step_*.tmp``
then rename; ``latest_step`` never reports a directory without its
manifest) — plus a bfloat16 round trip and the cross-package layout: the
same tree saved by both stores has the same leaf paths and bitwise-equal
shard arrays."""
import json
import os
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.checkpoint.store import (  # noqa: E402
    _flatten_with_paths as ref_flatten)
from repro_torch.checkpoint import (latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.store import (MANIFEST,  # noqa: E402
                                          _flatten_with_paths)


class Carry(NamedTuple):
    U: torch.Tensor
    step: torch.Tensor


def _tree():
    return {
        "params": [torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   torch.ones(4, dtype=torch.float64) * np.pi],
        "carry": Carry(U=torch.eye(3, dtype=torch.float64),
                       step=torch.tensor(7, dtype=torch.int32)),
        "scalar": torch.tensor(2.5, dtype=torch.float16),
    }


def _like(tree):
    return {"params": [torch.zeros_like(t) for t in tree["params"]],
            "carry": Carry(*(torch.zeros_like(t) for t in tree["carry"])),
            "scalar": torch.zeros_like(tree["scalar"])}


def _leaves(tree):
    return [leaf for _, leaf in _flatten_with_paths(tree)]


# ------------------------------------------------------------ round trip

def test_roundtrip_nested_pytree(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree)
    out = restore_checkpoint(str(tmp_path), 3, _like(tree))
    flat_in, flat_out = _leaves(tree), _leaves(out)
    assert len(flat_in) == len(flat_out)
    for a, b in zip(flat_in, flat_out):
        assert a.dtype == b.dtype, "dtype must survive the round trip"
        assert a.shape == b.shape
        assert torch.equal(a, b)
    # structure (incl. the NamedTuple node) survives
    assert isinstance(out["carry"], Carry)
    assert isinstance(out["params"], list)


def test_paths_follow_the_reference():
    """Sorted dict keys, list indices, NamedTuple fields as ``.name``."""
    paths = [p for p, _ in _flatten_with_paths(_tree())]
    assert paths == ["carry/.U", "carry/.step", "params/0", "params/1",
                     "scalar"]


def test_roundtrip_many_shards(tmp_path):
    tree = {"a": torch.arange(1000, dtype=torch.float32),
            "b": torch.arange(1000, dtype=torch.float64),
            "c": torch.arange(10, dtype=torch.int32)}
    path = save_checkpoint(str(tmp_path), 0, tree, shard_bytes=4096)
    shards = [f for f in os.listdir(path) if f.startswith("shard_")]
    assert len(shards) > 1, "shard_bytes must chunk the leaves"
    out = restore_checkpoint(str(tmp_path), 0,
                             {k: torch.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        assert torch.equal(out[k], tree[k])
        assert out[k].dtype == tree[k].dtype


def test_missing_leaf_raises_keyerror(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 1,
                           {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_extra_manifest_leaves_are_ignored(tmp_path):
    # the serving reader restores only {"U"} out of {"U", "U_nodes"}
    save_checkpoint(str(tmp_path), 2, {"U": torch.ones((3, 2)),
                                       "U_nodes": torch.ones((4, 3, 2))})
    out = restore_checkpoint(str(tmp_path), 2, {"U": torch.zeros((3, 2))})
    assert bool(torch.all(out["U"] == 1))


def test_bfloat16_round_trips_through_its_bits(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    path = save_checkpoint(str(tmp_path), 1, {"x": x, "y": (x[0],)})
    with open(os.path.join(path, MANIFEST)) as f:
        assert json.load(f)["dtypes"] == {"x": "bfloat16",
                                          "y/0": "bfloat16"}
    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        assert z["a0"].dtype == np.uint16
    out = restore_checkpoint(str(tmp_path), 1,
                             {"x": torch.zeros_like(x),
                              "y": (torch.zeros(7, dtype=torch.bfloat16),)})
    assert out["x"].dtype == torch.bfloat16 and torch.equal(out["x"], x)
    assert isinstance(out["y"], tuple) and torch.equal(out["y"][0], x[0])
    # a float32 template takes the bf16 values exactly
    f32 = restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(5, 7)})
    assert torch.equal(f32["x"], x.float())


def test_restore_follows_the_template_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"U": torch.eye(3, dtype=torch.float64)})
    out = restore_checkpoint(str(tmp_path), 0,
                             {"U": torch.zeros(3, 3, dtype=torch.float32)})
    assert out["U"].dtype == torch.float32
    assert torch.equal(out["U"], torch.eye(3))


# ------------------------------------------------------------ latest_step

def test_latest_step_empty_and_missing(tmp_path):
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "nope")) is None


def test_latest_step_orders_numerically(tmp_path):
    for s in (3, 10, 7):
        save_checkpoint(str(tmp_path), s, {"x": torch.zeros(2)})
    assert latest_step(str(tmp_path)) == 10


# ------------------------------------------------------------ crash safety

def test_save_stages_then_renames(tmp_path):
    path = save_checkpoint(str(tmp_path), 5, {"x": torch.ones(4)})
    assert os.path.isdir(path)
    assert not os.path.isdir(path + ".tmp"), \
        "the staging dir must be renamed away on completion"
    assert os.path.isfile(os.path.join(path, MANIFEST))


def test_latest_step_skips_manifestless_dir(tmp_path):
    # simulate a save killed after shard writes but before the manifest
    save_checkpoint(str(tmp_path), 2, {"x": torch.zeros(2)})
    dead = tmp_path / "step_000000009"
    dead.mkdir()
    (dead / "shard_00000.npz").write_bytes(b"partial")
    assert latest_step(str(tmp_path)) == 2


def test_latest_step_ignores_tmp_staging_dir(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    staging = tmp_path / "step_000000008.tmp"
    staging.mkdir()
    (staging / MANIFEST).write_bytes(b"in flight")
    assert latest_step(str(tmp_path)) == 1


def test_save_clears_stale_staging_and_overwrites(tmp_path):
    # a stale .tmp from a killed save must not break the next save,
    # and re-saving a step replaces the old content
    stale = tmp_path / "step_000000004.tmp"
    stale.mkdir()
    (stale / "junk").write_bytes(b"x")
    save_checkpoint(str(tmp_path), 4, {"x": torch.ones(3)})
    assert not stale.exists()
    save_checkpoint(str(tmp_path), 4, {"x": torch.full((3,), 9.0)})
    out = restore_checkpoint(str(tmp_path), 4, {"x": torch.zeros(3)})
    assert bool(torch.all(out["x"] == 9.0))


# ------------------------------------------------------------ cross-package

class RefCarry(NamedTuple):
    U: object
    step: object


def test_same_tree_same_layout_in_both_stores(tmp_path):
    """One tree, saved by the reference store (jax arrays) and by the
    port (tensors): the same leaf paths in the same shard slots, and
    bitwise-equal shard arrays, with the reference's chunking."""
    rng = np.random.default_rng(0)
    host = {"params": [rng.standard_normal((2, 3)).astype(np.float32),
                       rng.standard_normal(400)],
            "carry": (rng.standard_normal((3, 3)), np.int32(7)),
            "scalar": np.float16(2.5)}
    jtree = {"params": [jnp.asarray(a) for a in host["params"]],
             "carry": RefCarry(*(jnp.asarray(a) for a in host["carry"])),
             "scalar": jnp.asarray(host["scalar"])}
    ttree = {"params": [torch.as_tensor(a) for a in host["params"]],
             "carry": Carry(*(torch.as_tensor(np.asarray(a))
                              for a in host["carry"])),
             "scalar": torch.as_tensor(np.asarray(host["scalar"]))}
    assert ([p for p, _ in _flatten_with_paths(ttree)]
            == ref_flatten(jtree)[0])
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    rp = ref_save(str(ref_dir), 6, jtree, shard_bytes=1024)
    pp = save_checkpoint(str(port_dir), 6, ttree, shard_bytes=1024)
    assert os.path.basename(rp) == os.path.basename(pp) == "step_000000006"
    shards = sorted(f for f in os.listdir(rp) if f.startswith("shard_"))
    assert len(shards) > 1
    assert shards == sorted(f for f in os.listdir(pp)
                            if f.startswith("shard_"))
    for name in shards:
        with np.load(os.path.join(rp, name)) as a, \
                np.load(os.path.join(pp, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    # both manifests index every leaf path to the same (shard, key)
    import msgpack
    with open(os.path.join(rp, "manifest.msgpack"), "rb") as f:
        m = msgpack.unpackb(f.read())
    with open(os.path.join(pp, MANIFEST)) as f:
        assert json.load(f)["index"] == m["index"]
