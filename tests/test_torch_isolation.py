"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the CUDA card unless the caller asks for the CPU.
"""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core.executor import Executor, resolve_device
from paddle_tpu_torch.serving import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
SOURCES = sorted(glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
                 + [os.path.join(REPO, "chip_smoke.py"),
                    os.path.join(REPO, "k6_ablation.py"),
                    os.path.join(REPO, "k9_ablation.py")])
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(module):
    return module is not None and module.split(".")[0] in FORBIDDEN


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.io, "
            "paddle_tpu_torch.serving, paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.models.understand_sentiment, "
            "paddle_tpu_torch.nets, paddle_tpu_torch.core.lod, "
            "paddle_tpu_torch.layers.sequence, "
            "paddle_tpu_torch.ops.sequence_ops, "
            "paddle_tpu_torch.ops.cuda_kernels, "
            "paddle_tpu_torch.layers.control_flow, "
            "paddle_tpu_torch.ops.control_ops, "
            "paddle_tpu_torch.models.common, "
            "paddle_tpu_torch.models.machine_translation, "
            "paddle_tpu_torch.checkpoint, paddle_tpu_torch.core.utils, "
            "paddle_tpu_torch.reference_format, "
            "paddle_tpu_torch.resilience, paddle_tpu_torch.ops.guard_ops, "
            "paddle_tpu_torch.parallel, paddle_tpu_torch.transpiler, "
            "paddle_tpu_torch.core.sharded, "
            "paddle_tpu_torch.parallel.pipeline, "
            "paddle_tpu_torch.parallel.moe, "
            "paddle_tpu_torch.ops.parallel_ops, "
            "paddle_tpu_torch.layers.parallel_layers, "
            "paddle_tpu_torch.memory_optimization_transpiler, "
            "paddle_tpu_torch.serving.pool, "
            "paddle_tpu_torch.serving.canary, "
            "paddle_tpu_torch.serving.fleet, "
            "paddle_tpu_torch.serving.autoscaler, "
            "paddle_tpu_torch.resilience.heartbeat, "
            "paddle_tpu_torch.resilience.cluster, "
            "paddle_tpu_torch.observability.registry\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r)\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__"):
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, "%s:%d imports %s" % (path, node.lineno, bad)


def test_every_persistence_module_is_checked():
    """The checkpoint package, the era-wire format and the durability
    helpers are among the sources the import check above walks."""
    rel = {os.path.relpath(p, PKG) for p in SOURCES}
    assert {"checkpoint/__init__.py", "checkpoint/manager.py",
            "checkpoint/snapshot.py", "checkpoint/retention.py",
            "core/utils.py", "reference_format.py"} <= rel


def test_every_resilience_module_is_checked():
    """The resilience package and the guard ops are among the sources the
    import check above walks."""
    rel = {os.path.relpath(p, PKG) for p in SOURCES}
    assert {"resilience/__init__.py", "resilience/faults.py",
            "resilience/guards.py", "resilience/watchdog.py",
            "resilience/sentinel.py", "resilience/sdc.py",
            "resilience/supervisor.py", "ops/guard_ops.py"} <= rel


def test_every_serving_fleet_module_is_checked():
    """The replica pool, canary, fleet, autoscaler, heartbeat and plan
    modules are among the sources the import check above walks."""
    rel = {os.path.relpath(p, PKG) for p in SOURCES}
    assert {"serving/pool.py", "serving/canary.py", "serving/fleet.py",
            "serving/autoscaler.py", "resilience/heartbeat.py",
            "resilience/cluster.py", "observability/registry.py",
            "core/dispatch.py"} <= rel


def test_pool_and_tp_engine_need_a_card_or_an_explicit_cpu(no_card,
                                                             tmp_path):
    """No card: a pool's default placement (CUDAPlace(i)) refuses before
    any model is read, and a tp engine with no mesh_devices finds no
    device to span; nothing falls back to the CPU."""
    from paddle_tpu_torch.serving import ReplicaPool
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaPool(str(tmp_path / "absent"), replicas=2)
    with pytest.raises(ValueError, match="only 0 are visible"):
        InferenceEngine(str(tmp_path / "absent"), tp=2)


def test_canary_checks_the_card_or_the_devices_given(no_card):
    """No card and no devices=: the canary refuses rather than checking
    the CPU in the card's place."""
    from paddle_tpu_torch.resilience import CanaryChecker
    with pytest.raises(RuntimeError, match="CUDA"):
        CanaryChecker().check()
    assert CanaryChecker(shape=(8, 8), devices=["cpu"]).check()


def test_every_sequence_module_is_checked():
    """The sequence slice's modules are among the sources the import check
    above walks."""
    rel = {os.path.relpath(p, PKG) for p in SOURCES}
    assert {"core/lod.py", "ops/sequence_ops.py", "layers/sequence.py",
            "nets.py", "models/understand_sentiment.py"} <= rel


def test_every_control_flow_and_translation_module_is_checked():
    """The translator slice's modules are among the sources the import
    check walks."""
    rel = {os.path.relpath(p, PKG) for p in SOURCES}
    assert {"layers/control_flow.py", "ops/control_ops.py",
            "models/common.py", "models/machine_translation.py"} <= rel


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_needs_a_card_or_an_explicit_cpu(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Executor("cuda:0")
    assert Executor("cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_engine_raises_before_reading_the_model(no_card, tmp_path):
    """No card, no device="cpu": the engine refuses before it opens the
    directory (which here holds no model at all)."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(str(tmp_path / "absent"))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py alone in a directory, on a machine without CUDA,
    exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        script.write_text(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
