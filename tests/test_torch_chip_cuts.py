"""The cuts of ``chip_smoke.py``'s LM phases, held on the CPU.

``chip_smoke.py`` serves and trains the LM zoo on one 80 GB card, each
configuration cut in depth (and in nodes and shape) where it would not
fit whole.  A later change to a cut should fail here, not on the card:

* each training case of ``TRAIN_CASES``: the dry run
  (``launch.dryrun.run_one`` on a (1, 1) mesh, on the meta device) at
  the case's layers, nodes, per-node batch and sequence predicts a peak
  inside the card's memory (``launch.mesh.HBM_BYTES``), and its kernel
  launches are the phase's derived count; a vlm case's sequence is
  longer than its patch rows (``vis_tokens``), or it would hold no text;
* each serving case (``LM_PLANS``, phase 17b): ``lm_phase``
  builds the whole f32 tree first and casts the serving copy from it a
  leaf at a time, so the f32 tree (``cfg.n_params()`` × 4 bytes) plus
  the largest leaf's bf16 copy must fit; the tree's parameters are
  ``cfg.n_params()``, and the flash launches of a prefill step those of
  the plan.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES, MeshShape  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.models.transformer import serving_params  # noqa: E402
from repro_torch.utils.trees import tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _cut(arch, layers):
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


@pytest.mark.parametrize("case", CS.TRAIN_CASES, ids=lambda c: c[0])
def test_train_case_fits_the_card(case):
    arch, layers, nodes, per_node, seq = case
    cfg = _cut(arch, layers)
    if cfg.modality == "vlm":
        assert seq > cfg.vis_tokens, (seq, cfg.vis_tokens)
    rec = dryrun.run_one(arch, InputShape("train_phase", seq,
                                          nodes * per_node, "train"),
                         mesh=MeshShape(("data", "model"), (1, 1)),
                         cfg=cfg, n_nodes=nodes)
    assert rec["memory"]["peak_bytes"] < HBM_BYTES, rec["memory"]
    launches = {k: v for k, v in rec["kernel_launches"].items()
                if k != "gossip_combine"}
    assert launches == {k: v for k, v in CS.train_launches(
        cfg, "diffusion", 0, nodes).items() if k != "gossip_combine"}


def test_the_zamba2_case_keeps_a_group_and_llava_its_text():
    """Below one group zamba2 runs no flash; at 1024 tokens llava has no
    text: the two traps the cuts must avoid."""
    cases = {c[0]: c for c in CS.TRAIN_CASES}
    zamba = _cut("zamba2-7b", cases["zamba2-7b"][1])
    assert CS.plan_launches(zamba) == {"ssd_scan": 6, "flash_attention": 1}
    assert CS.plan_launches(dataclasses.replace(zamba, n_layers=5)).get(
        "flash_attention", 0) == 0
    llava = get_config("llava-next-mistral-7b")
    assert CS.TRAIN_SEQ <= llava.vis_tokens < cases[llava.name][4]


def _serving_cases():
    return [(arch, layers, want) for arch, layers, _, want in CS.LM_PLANS]


@pytest.mark.parametrize("case", _serving_cases(), ids=lambda c: c[0])
def test_serving_case_f32_tree_and_cast_fit_the_card(case):
    arch, layers, want = case
    cfg = _cut(arch, layers)
    tree = specs.abstract_params(cfg)
    before = {p: x.dtype for p, x in tree_leaves_with_path(tree)}
    assert sum(x.numel() for _, x in tree_leaves_with_path(tree)) == \
        cfg.n_params()
    cast = serving_params(tree, cfg)
    largest = max((x.numel() * x.element_size()
                   for p, x in tree_leaves_with_path(cast)
                   if x.dtype != before[p]), default=0)
    assert largest > 0
    assert cfg.n_params() * 4 + largest < HBM_BYTES, (
        arch, cfg.n_params() * 4 / 2 ** 30, largest / 2 ** 30)
    assert CS.plan_launches(cfg) == want


def test_mqa_leaves_out_only_the_kv_head_reversal():
    """granite-20b's one KV head: reversing the KV heads is no fault
    there, so it alone leaves the planted set; every other model plants
    all four flash faults."""
    for arch, layers, _, want in CS.LM_PLANS:
        if "flash_attention" not in want:
            continue
        hkv = CS.lm_kernel_shapes(_cut(arch, layers), 4, 2048)[
            "flash_attention"][3]
        left_out = CS.flash_faults_not_planted(hkv)
        assert set(left_out) == ({"kv_heads_reversed"} if hkv == 1
                                 else set()), arch
        assert set(left_out) <= set(CS.LM_BF16_CAUGHT)
    assert get_config("granite-20b").n_kv_heads == 1
    assert get_config("musicgen-medium").n_kv_heads == 24
