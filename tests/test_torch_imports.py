"""The PyTorch port stands alone: no module of ``paddle_tpu_torch``, and
not ``chip_smoke.py``, imports JAX or the JAX package, and the entry
points refuse to fall back to the CPU quietly."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}
# the training slice's modules, which both scans must reach
TRAINING_MODULES = (
    "paddle_tpu_torch.jit.train_step", "paddle_tpu_torch.nn.clip",
    "paddle_tpu_torch.nn.functional.flash_attention",
    "paddle_tpu_torch.nn.functional.loss",
    "paddle_tpu_torch.ops.hopper.flash_attention",
    "paddle_tpu_torch.optimizer.optimizer",
    "paddle_tpu_torch.optimizer.optimizers")
# the ResNet training slice's modules, which both scans must reach
RESNET_MODULES = (
    "paddle_tpu_torch.nn.functional.activation",
    "paddle_tpu_torch.nn.functional.common",
    "paddle_tpu_torch.nn.functional.conv",
    "paddle_tpu_torch.nn.functional.norm",
    "paddle_tpu_torch.nn.functional.pooling",
    "paddle_tpu_torch.nn.layer._init", "paddle_tpu_torch.nn.layer._layout",
    "paddle_tpu_torch.nn.layer.activation", "paddle_tpu_torch.nn.layer.common",
    "paddle_tpu_torch.nn.layer.conv", "paddle_tpu_torch.nn.layer.loss",
    "paddle_tpu_torch.nn.layer.norm", "paddle_tpu_torch.nn.layer.pooling",
    "paddle_tpu_torch.ops.hopper.bn_stats",
    "paddle_tpu_torch.ops.hopper.resnet_unit",
    "paddle_tpu_torch.vision.models.resnet")


# the serving slice's modules, which both scans must reach
SERVING_MODULES = (
    "paddle_tpu_torch.distributed.fault", "paddle_tpu_torch.serving.engine",
    "paddle_tpu_torch.serving.host_tier", "paddle_tpu_torch.serving.kv_pool",
    "paddle_tpu_torch.serving.robustness",
    "paddle_tpu_torch.serving.speculation")
# the telemetry package and the degraded-path report, which both scans
# must reach
TELEMETRY_MODULES = (
    "paddle_tpu_torch.distributed.watchdog", "paddle_tpu_torch.telemetry",
    "paddle_tpu_torch.telemetry.aggregate",
    "paddle_tpu_torch.telemetry.exporters",
    "paddle_tpu_torch.telemetry.flight",
    "paddle_tpu_torch.telemetry.registry",
    "paddle_tpu_torch.telemetry.requests",
    "paddle_tpu_torch.telemetry.tracer")
# the serving fleet (router, autoscaler, disaggregation, migration), which
# both scans must reach
FLEET_MODULES = (
    "paddle_tpu_torch.serving.fleet",
    "paddle_tpu_torch.serving.fleet.autoscaler",
    "paddle_tpu_torch.serving.fleet.disagg",
    "paddle_tpu_torch.serving.fleet.migrate",
    "paddle_tpu_torch.serving.fleet.router")


# weight-only int8 serving and the training surface (recompute, the
# schedulers, the optimizers, the losses), which both scans must reach
INT8_AND_TRAINING_SURFACE_MODULES = (
    "paddle_tpu_torch.distributed.fleet.mpu",
    "paddle_tpu_torch.distributed.fleet.recompute",
    "paddle_tpu_torch.models.generation",
    "paddle_tpu_torch.nn.functional.loss", "paddle_tpu_torch.nn.layer.loss",
    "paddle_tpu_torch.ops.hopper.int8_matmul",
    "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.optimizer.optimizer",
    "paddle_tpu_torch.optimizer.optimizers")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, prefix="paddle_tpu_torch."))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_imports_with_jax_and_reference_poisoned():
    """With ``jax`` and ``paddle_tpu`` unimportable, every port module
    and chip_smoke import in a fresh interpreter."""
    mods = _port_modules() + ["chip_smoke"]
    assert (set(TRAINING_MODULES) | set(RESNET_MODULES)
            | set(SERVING_MODULES) | set(TELEMETRY_MODULES)
            | set(FLEET_MODULES)
            | set(INT8_AND_TRAINING_SURFACE_MODULES)) <= set(mods)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_telemetry_off_by_default_starts_no_thread():
    """In a fresh interpreter with the JAX package poisoned, importing the
    telemetry package and building and stepping an engine with
    ``FLAGS_telemetry`` at its default (off) starts no thread and
    retains nothing."""
    code = ("import sys, threading\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu'):\n"
            "    sys.modules[m] = None\n"
            "before = {t.name for t in threading.enumerate()}\n"
            "import paddle_tpu_torch.telemetry as tel\n"
            "from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM\n"
            "from paddle_tpu_torch import ServingEngine, flags\n"
            "assert flags.flag_value('telemetry') is False\n"
            "flags.set_flags({'telemetry_export_interval': 0.05})\n"
            "m = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),\n"
            "                     device='cpu')\n"
            "e = ServingEngine.from_model(m, device='cpu', block_size=4,\n"
            "                             max_slots=2, prefill_chunk=8)\n"
            "rid = e.add_request([1, 2, 3], max_new_tokens=2)\n"
            "assert e.run()[rid].events == []\n"
            "e.drain()\n"
            "assert tel.maybe_start_exporter() is None\n"
            "assert {t.name for t in threading.enumerate()} == before\n"
            "assert tel.snapshot() == {} and tel.snapshot_spans() == []\n"
            "assert tel.flight().snapshot() == [] and tel.flight().dumps == 0\n"
            "assert tel.snapshot_requests() == {}\n"
            "print('inert')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FLAGS_telemetry")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "inert" in proc.stdout


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    """AST scan: no absolute import names jax or the JAX package. The
    scan covers every source of the package (the training, ResNet,
    telemetry and fleet modules among them) and chip_smoke.py."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path}:{node.lineno} imports {name}")


def test_fleet_sources_are_scanned():
    """The AST scan reaches every module of ``serving/fleet``."""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in FLEET_MODULES:
        rel = mod.replace(".", os.sep)
        assert (rel + ".py" in scanned
                or os.path.join(rel, "__init__.py") in scanned), mod


def test_entry_points_raise_without_a_card(monkeypatch):
    """No device argument means the card: with none present the model
    and the engine raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.from_model(model)
    assert ServingEngine.from_model(model, device="cpu").device.type == "cpu"


def test_kv_block_pool_raises_without_a_card(monkeypatch):
    """The pool is a public entry point too: with no device argument it
    takes the card and raises without one; ``device="cpu"`` works."""
    from paddle_tpu_torch.serving import KVBlockPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(num_layers=1, num_blocks=4, block_size=4, kv_heads=1,
              head_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVBlockPool(**kw)
    pool = KVBlockPool(**kw, device="cpu")
    assert pool.device.type == "cpu" and pool.kbufs[0].device.type == "cpu"


def test_resnet_entry_points_raise_without_a_card(monkeypatch):
    """resnet50() and the layers it is built from take the card with no
    device argument, and raise without one."""
    from paddle_tpu_torch.nn import BatchNorm2D, Conv2D
    from paddle_tpu_torch.vision.models import resnet18, resnet50

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (resnet50, lambda: Conv2D(3, 8, 3), lambda: BatchNorm2D(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resnet18(device="cpu").fc.weight.device.type == "cpu"


def test_chip_smoke_without_a_card_exits_nonzero_and_prints_no_result():
    """chip_smoke.py refuses to run without CUDA and prints nothing on
    stdout (the result line exists only after a run on the card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
