"""The port keeps the JAX package's public names: every top-level public
name that a `posegen_tpu` module defines has a counterpart in its
`posegen_tpu_torch` twin, by the same name or by the map below of renamed
and TPU-only names, each with its reason; every name a JAX package
`__init__` exports imports from the port's package; and each of the port's
packages imports first in a fresh interpreter without jax.

The JAX modules are parsed with `ast`, never imported."""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "posegen_tpu", ROOT / "posegen_tpu_torch"

# (JAX module, JAX name) -> (the port's names in the twin module, reason);
# no names: TPU-only, with nothing to carry over
MAPPED = {
    ("kernels/field.py", "FusedFieldParams"): (
        ("FieldNet",), "one net's packed weights: the CUDA kernels read one flat bf16 buffer"),
    ("kernels/field.py", "prepare_params"): (
        ("prepare_net",), "packs a net for the eval kernels, as FieldNet"),
    ("kernels/field.py", "flatten_weights"): (
        ("prepare_net",), "Pallas takes the weights as a list of refs; prepare_net packs one buffer"),
    ("kernels/field.py", "supports_fused_config"): (
        ("fused_config_disqualification",), "the gate returns the reason it refuses, None to take"),
    ("kernels/field.py", "encode_channels"): (
        (), "the in-kernel encode over Pallas refs; its plain twin is encode_plain"),
    ("kernels/field.py", "encode_intermediates"): (
        (), "the Pallas backward's encode over refs; its plain twin is encode_bwd_plain"),
    ("kernels/field.py", "grouped_specs"): (
        (), "Pallas BlockSpecs; the CUDA kernel's grouped modes take a pose table instead"),
    ("kernels/field.py", "mm_t"): (
        (), "the MXU dot_general of a Pallas body; the plain versions' product is _mm"),
    ("kernels/field.py", "MM_DTYPE"): (
        (), "the Pallas operands' dtype, patched by tests; the plain versions take mm_dtype"),
    ("kernels/field.py", "POINT_TILE"): (
        (), "the TPU eval tile in VMEM; the CUDA eval tile is EVAL_TILE"),
    ("kernels/field.py", "NF_KP"): (
        ("net_layout",), "the flagship's octaves; every port call takes its layout's nf_kp"),
    ("kernels/field.py", "NF_VIEW"): (
        ("net_layout",), "the flagship's view octaves; the layout's nf_view"),
    ("kernels/field.py", "KP_CH"): (("kp_ch",), "the flagship's value of kp_ch()"),
    ("kernels/field.py", "PTS_CH"): (("pts_ch",), "the flagship's value of pts_ch()"),
    ("kernels/field.py", "VIEW_CH"): (("view_ch",), "the flagship's value of view_ch()"),
    ("kernels/field_grad.py", "TRAIN_TILE"): (
        (), "the TPU training tile in VMEM; pass (a)'s CUDA tile is A_TILE"),
    ("kernels/field_grad.py", "MAX_TRAIN_TILE"): ((), "the largest TPU training tile"),
    ("kernels/field_grad.py", "pick_train_tile"): (
        (), "picks the TPU grid's tile; the CUDA kernels take any group size"),
    ("kernels/field_grad.py", "STASH_BWD"): (
        (), "the JAX backward's stash-or-recompute switch; the port always stashes"),
    ("kernels/field_grad.py", "make_trainable_field"): (
        ("trainable_field",), "an autograd function where JAX builds a custom_vjp"),
    ("data/native.py", "build_lib"): (("build",), "builds the host sampler with g++"),
    ("train/trainer.py", "pose_optimizer"): (
        ("pose_lr", "pose_update"), "optax's Adam + MultiSteps as a schedule and an update"),
}


def _modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _defined(tree: ast.Module):
    """Top-level public names a module defines (functions, classes,
    assignments, and definitions under a top-level if / try)."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.If, ast.Try)):
            out |= {n.name for n in ast.walk(node)
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    return {n for n in out if not n.startswith("_")}


def _bound(tree: ast.Module):
    """Every name bound at the top level, imports included."""
    out = _defined(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


@pytest.mark.parametrize("module", _modules())
def test_public_names_have_counterparts(module):
    twin = PORT / module
    assert twin.exists(), f"posegen_tpu/{module} has no twin in posegen_tpu_torch"
    jax_names, port_names = _defined(_parse(JAX / module)), _bound(_parse(twin))
    missing = sorted(n for n in jax_names - port_names if (module, n) not in MAPPED)
    assert not missing, f"posegen_tpu/{module}: no counterpart for {missing}"
    for (mod, name), (counterparts, reason) in MAPPED.items():
        if mod != module:
            continue
        assert reason and name in jax_names, f"{mod}::{name} is mapped but not defined there"
        assert name not in port_names, f"{mod}::{name} is mapped but the twin defines it"
        for c in counterparts:
            assert c in port_names, f"{mod}::{name} maps to {c}, which the twin lacks"


def _exports(init: pathlib.Path):
    """(JAX package, names its __init__ imports from within the package)."""
    package = ".".join(("posegen_tpu", *init.parent.relative_to(JAX).parts))
    names = []
    for node in _parse(init).body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(package):
            names += [a.asname or a.name for a in node.names]
    return package, names


EXPORTS = {p: names for p, names in map(_exports, sorted(JAX.rglob("__init__.py"))) if names}


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_package_exports_import_from_the_port(package):
    port_package = package.replace("posegen_tpu", "posegen_tpu_torch", 1)
    mod = importlib.import_module(port_package)
    mapped = {name: c for (m, name), (c, _) in MAPPED.items()}
    for name in EXPORTS[package]:
        for c in mapped.get(name, (name,)):
            assert getattr(mod, c, None) is not None, f"{port_package} does not export {c}"
            assert c in getattr(mod, "__all__", (c,)), f"{port_package}.__all__ lacks {c}"


CHILD = """
import importlib, os, sys
import numpy, torch  # the cost every package shares, paid once before the forks

pids = {}
for package in sys.argv[1:]:
    pid = os.fork()
    if pid == 0:
        code = 0
        try:
            m = importlib.import_module(package)
            for name in getattr(m, "__all__", ()):
                getattr(m, name)
            bad = sorted(k for k in sys.modules if k.split(".")[0] in
                         ("jax", "posegen_tpu", "cv2", "PIL", "h5py", "plotly"))
            if bad:
                print(package, "imports", bad)
                code = 1
        except BaseException as e:
            print(package, repr(e))
            code = 1
        sys.stdout.flush()
        os._exit(code)
    pids[pid] = package
failed = [package for pid, package in pids.items() if os.waitpid(pid, 0)[1]]
print("failed:", failed)
sys.exit(1 if failed else 0)
"""


def test_each_package_imports_first_in_a_fresh_interpreter():
    """One child interpreter imports torch, then forks a process per port
    package, all at once: each imports its package first and resolves
    every export, so a cycle between packages fails here; none loads jax,
    the JAX package, cv2, PIL, h5py or plotly."""
    packages = ["posegen_tpu_torch"] + sorted(
        f"posegen_tpu_torch.{p.parent.name}" for p in PORT.glob("*/__init__.py"))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", CHILD, *packages], cwd=str(ROOT), env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-4000:]
    assert "failed: []" in out.stdout
