"""What the port covers of the JAX package, by ``ast`` alone (no JAX).

- Every public top-level name that a ``naf_tpu/**/*.py`` module defines has
  a counterpart in the ``naf_torch`` module of the same path (defined or
  imported there), or an entry with its reason in ``NOT_PORTED``; an entry
  whose name the port has, or the JAX module no longer defines, fails too.
- Every root script of the JAX side (``*.py`` at the root, ``evaluation/``,
  ``examples/``, ``tools/``) maps to a port entry point in ``ENTRY_POINTS``
  (a module of ``naf_torch`` that a user runs, or ``chip_smoke.py``) or to
  a reason in ``NO_ENTRY_POINT``.
- ``naf_torch.data.DATASET_REGISTRY`` has the JAX registry's keys, each on
  the port's class of the same name.
- No module of the port, and not ``chip_smoke.py``, imports JAX, flax or
  ``naf_tpu``.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT = REPO / "naf_tpu", REPO / "naf_torch"

_ROUTE = "TPU route gate (Pallas/Mosaic applicability); the port's kernels take every shape"
_TILING = "TPU tiling (Mosaic blocks and lane layout); the port plans its own tiles"
NOT_PORTED = {
    ("kernels/adaptive_conv_fused.py", "adaptive_conv_fused_applicable"): _ROUTE,
    ("kernels/encoder_fused.py", "dual_encoder_applicable"): _ROUTE,
    ("kernels/encoder_fused.py", "fused_encoder_applicable"): _ROUTE,
    ("kernels/encoder_fused.py", "carry_layout"): _TILING,
    ("kernels/encoder_fused.py", "DUAL_ROUTE"):
        "the switch to the K6 route, which lost to the K1 pair on the card; K6 is kept as an op "
        "(gn_silu_conv_dual_fused) and no route of the port takes it",
    ("kernels/na2d_fused.py", "fused_applicable"): _ROUTE,
    ("kernels/na2d_fused.py", "pick_cell_blocks"): _TILING,
    ("kernels/na2d_fused.py", "pick_cell_blocks_bwd"): _TILING,
    ("kernels/na2d_fused_q.py", "fused_q_applicable"): _ROUTE,
    ("kernels/na2d_fused_q.py", "pick_geometry"): _TILING,
    ("train/trainer.py", "fold_step_key"):
        "JAX PRNG: folds the step into a key; the port draws from torch generators",
    ("convert.py", "naf_params_from_torch"):
        "torch -> JAX converter; the port loads torch state dicts directly",
    ("convert.py", "convert_conv"): "torch -> JAX converter (a conv's kernel layout)",
    ("convert.py", "convert_encoder"): "torch -> JAX converter (an encoder stack)",
    ("convert.py", "convert_groupnorm"): "torch -> JAX converter (a GroupNorm)",
    ("models/featup.py", "featup_params_from_torch"):
        "torch -> JAX converter; the port's registry loads torch checkpoints directly",
    ("models/anyup.py", "convert_checkpoint"):
        "torch -> JAX converter; the port's registry loads torch checkpoints directly",
    ("config/core.py", "instantiate"):
        "the configs' _target_s name naf_tpu classes (naf_torch/config/core.py:16); the "
        "port's CLIs build their objects by name",
    ("train/trainer.py", "make_viz_fn"): "the port's trainer draws its panels in _viz",
    ("nn/conv.py", "reflect_conv"):
        "a factory of ReflectConv in JAX; the port builds naf_torch/nn/conv.py's ReflectConv",
    ("nn/rope.py", "rope_apply"): "named otherwise in naf_torch/nn/rope.py: RoPE.forward",
    ("nn/rope.py", "rope_rotate_half"): "named otherwise in naf_torch/nn/rope.py: rotate_half",
    ("backbones/wrapper.py", "OPENAI_CLIP_MEAN"): "unused in the JAX package",
    ("backbones/wrapper.py", "OPENAI_CLIP_STD"): "unused in the JAX package",
}

_HEADLINE = "naf_torch/bench/headline.py"
ENTRY_POINTS = {
    "bench.py": _HEADLINE,
    "train.py": "naf_torch/train/__main__.py",
    "denoising.py": "naf_torch/denoising.py",
    "__graft_entry__.py": "naf_torch/dryrun.py",
    "evaluation/eval_real_shard.py": "naf_torch/evals/real_shard.py",
    "evaluation/eval_seg_probing.py": "naf_torch/evals/seg_probing.py",
    "evaluation/eval_video_seg.py": "naf_torch/evals/video_seg.py",
    "examples/attention_maps.py": "naf_torch/examples/attention_maps.py",
    "examples/inference.py": "naf_torch/examples/inference.py",
    "tools/north_star.py": _HEADLINE,  # --only
    "tools/northstar_decomp.py": _HEADLINE,  # --stages
    "tools/stage_profile.py": _HEADLINE,  # --stages
    "tools/fused_q_profile.py": _HEADLINE,  # --stages; K2's ablations: tools/ablate_fused_q
    "tools/measure_mem.py": _HEADLINE,  # each field's peak
    "tools/run_denoising_bench.py": "naf_torch/evals/denoise_bench.py",
    "tools/train_distilled_eval.py": "naf_torch/evals/distill.py",
    "tools/tpu_kernel_check.py": "chip_smoke.py",
    "tools/encoder_diag_profile.py": "naf_torch/tools/ablate_encoder_tc.py",
    "tools/dual_encoder_profile.py": "naf_torch/tools/sweep_k6.py",
    "tools/fusedq_decomp.py": "naf_torch/tools/ablate_fused_q.py",
    "tools/fusedq_floor.py": "naf_torch/tools/ablate_fused_q.py",
    "tools/tpu_kernel_profile.py": "naf_torch/tools/ablate_na_tc.py",
}
_MOSAIC = ("a probe of the Pallas K2's Mosaic pipelining and DMA overlap on a TPU; the port's "
           "K2 is another kernel (naf_torch/tools/ablate_fused_q.py takes it apart)")
NO_ENTRY_POINT = {
    "tools/build_real_shard.py":
        "data preparation: writes the committed real shard (benchmarks/real_shard/), which "
        "both packages read",
    "tools/f32_bwd_probe.py": "decomposes the XLA f32 backward's cliff on a TPU",
    "tools/fusedq_dev.py": _MOSAIC,
    "tools/fusedq_geom_sweep.py": _MOSAIC,
    "tools/fusedq_overlap_probe.py": _MOSAIC,
    "tools/fusedq_read_floor.py": _MOSAIC,
    "tools/fusedq_stream_probe.py": _MOSAIC,
    "tools/pipe_probe.py": _MOSAIC,
    "tools/pipe_probe2.py": _MOSAIC,
    "tools/pipe_probe3.py": _MOSAIC,
    "tools/pipe_probe4.py": _MOSAIC,
    "tools/pipe_probe5.py": _MOSAIC,
    "tools/largeimg_probe.py": "isolates a TPU worker's crash at the 1792^2 LargeImg row",
    "tools/pooled_probe.py":
        "compares two XLA lowerings of RoPE.pooled's einsum on a TPU; eager torch has one",
    "tools/jax_denoise_memory.py":
        "sizes the JAX step by XLA's memory analysis without running it; the port measures "
        "the step's peak on the card (chip_smoke.py phase 14)",
}


def _defined(path: pathlib.Path) -> set:
    """Public names a module defines at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _visible(path: pathlib.Path) -> set:
    """Names a module defines or imports at its top level."""
    names = _defined(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _missing() -> set:
    """(module path, name) of every public JAX name without a counterpart
    in the port module of the same path."""
    out = set()
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG)
        port = PORT / rel
        assert port.exists(), f"naf_torch has no counterpart of naf_tpu/{rel}"
        for name in sorted(_defined(path) - _visible(port)):
            out.add((rel.as_posix(), name))
    return out


def test_every_public_name_has_a_counterpart_or_a_reason():
    missing = _missing()
    unexplained = sorted(missing - set(NOT_PORTED))
    stale = sorted(set(NOT_PORTED) - missing)
    assert not unexplained, f"public JAX names with no counterpart and no reason: {unexplained}"
    assert not stale, f"reasons for names the port has or JAX no longer defines: {stale}"
    assert all(isinstance(r, str) and len(r) > 10 for r in NOT_PORTED.values())


def _root_scripts() -> set:
    scripts = {p.name for p in REPO.glob("*.py") if p.name != "chip_smoke.py"}
    for folder in ("evaluation", "examples", "tools"):
        scripts |= {f"{folder}/{p.name}" for p in (REPO / folder).glob("*.py")}
    return scripts


def _runs_as_a_command(path: pathlib.Path) -> bool:
    """A module a user runs: a ``__main__.py``, or one with a ``main`` and
    an ``if __name__ == "__main__"`` block."""
    tree = ast.parse(path.read_text())
    has_main = any(isinstance(n, ast.FunctionDef) and n.name == "main" for n in tree.body)
    guarded = any(isinstance(n, ast.If) and "__main__" in ast.unparse(n.test) for n in tree.body)
    return path.name == "__main__.py" or (has_main and guarded)


def test_every_root_script_maps_to_an_entry_point_or_a_reason():
    scripts = _root_scripts()
    assert not set(ENTRY_POINTS) & set(NO_ENTRY_POINT)
    assert scripts == set(ENTRY_POINTS) | set(NO_ENTRY_POINT), (
        f"unmapped: {sorted(scripts - set(ENTRY_POINTS) - set(NO_ENTRY_POINT))}; "
        f"gone: {sorted(set(ENTRY_POINTS) | set(NO_ENTRY_POINT) - scripts)}")
    assert all(isinstance(r, str) and len(r) > 10 for r in NO_ENTRY_POINT.values())


@pytest.mark.parametrize("entry", sorted(set(ENTRY_POINTS.values())))
def test_entry_point_runs_as_a_command(entry):
    assert _runs_as_a_command(REPO / entry), f"{entry} has no command-line entry"


def _dict_literal(path: pathlib.Path, name: str) -> dict:
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name for t in node.targets)):
            return {k.value: ast.unparse(v) for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError(f"{path} assigns no dict {name}")


def test_dataset_registry_matches_jax():
    from naf_torch.data import DATASET_REGISTRY, datasets

    want = _dict_literal(JAX_PKG / "data" / "__init__.py", "DATASET_REGISTRY")
    assert len(want) == 7 and list(DATASET_REGISTRY) == list(want)
    for key, cls_name in want.items():
        assert DATASET_REGISTRY[key] is getattr(datasets, cls_name), key


def _imports(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = {str(p.relative_to(REPO)): sorted(_imports(p) & {"jax", "jaxlib", "flax", "optax",
                                                           "naf_tpu"})
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
