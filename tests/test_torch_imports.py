"""The port's boundaries: no JAX and nothing of the JAX package anywhere in
the port, no CPU fallback
for a CUDA request, no fallback when the kernels cannot be built."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from halo2_aggregation_tpu_torch import resolve_device
from halo2_aggregation_tpu_torch.ops import build

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "halo2_aggregation_tpu_torch"


def test_package_never_imports_jax():
    """No file of the port, and not `chip_smoke.py`, imports jax or the JAX
    package (`convert.py` included: it takes that package's objects by
    attribute)."""
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b"
        r"|(import|from)\s+halo2_aggregation_tpu(?!_torch)\b"
        r"|.*(import_module|__import__)\(\s*[\"']halo2_aggregation_tpu(?!_torch))",
        re.M,
    )
    offenders = [
        str(f.relative_to(ROOT))
        for f in sorted(PKG.rglob("*.py"))
        if pattern.search(f.read_text())
    ]
    assert offenders == []
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
    assert pattern.search("    from halo2_aggregation_tpu.fields import R")
    assert pattern.search("import halo2_aggregation_tpu")
    assert not pattern.search("from halo2_aggregation_tpu_torch.fields import R")


POISON = """
import sys
sys.modules["jax"] = None
sys.modules["halo2_aggregation_tpu"] = None
"""
NOTHING_LOADED = """
assert not {m.split(".")[0] for m, v in sys.modules.items() if v is not None} & {"jax", "jaxlib", "halo2_aggregation_tpu"}
"""


def test_slice_runs_with_jax_unimportable():
    """The port stands alone: with `jax` and the JAX package both made
    unimportable, run the B = 2 main path and prove at k = 9 with
    `create_proof_device` on CPU tensors, bytes equal to the port's own host
    provers `create_proof_native` and `create_proof`."""
    script = POISON + textwrap.dedent(
        """
        from halo2_aggregation_tpu_torch.models import simple_example as se
        from halo2_aggregation_tpu_torch.plonk import kzg
        from halo2_aggregation_tpu_torch.plonk.keygen import keygen
        from halo2_aggregation_tpu_torch.plonk.prover import create_proof
        from halo2_aggregation_tpu_torch.plonk.verifier import verify_proof
        from halo2_aggregation_tpu_torch.plonk.verifier_device import verify_batch
        params = kzg.setup(9)
        c0 = se.MyCircuit(constant=7, a=2, b=3)
        cs_e, _, asg_e = se.build(c0.without_witnesses(), k=9)
        vk, pk = keygen(params, cs_e, asg_e)
        _, _, asg = se.build(c0, k=9)
        pub = [c0.public_output()]
        proof = create_proof(params, pk, asg, [pub], seed=7)
        ok, efws = verify_batch(params, vk, [[pub]] * 2, [proof] * 2, device="cpu")
        ok_h, efw = verify_proof(params, vk, [pub], proof)
        assert ok is True and ok_h and efws == [tuple(efw)] * 2
        from halo2_aggregation_tpu_torch.plonk.prover_native import create_proof_native
        from halo2_aggregation_tpu_torch.plonk.prover_device import create_proof_device
        _, _, asg = se.build(c0, k=9)
        dev = create_proof_device(params, pk, asg, [pub], seed=7, device="cpu")
        _, _, asg = se.build(c0, k=9)
        assert dev == create_proof_native(params, pk, asg, [pub], seed=7) == proof
        """
    ) + NOTHING_LOADED + 'print("ALONE_OK")\n'
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ALONE_OK" in res.stdout


def test_every_module_imports_without_jax():
    """Each module of the package (the host copies, the MSM's `ops/msm`,
    `ops/msm_kernels`, `plonk/kzg` and `plonk/keygen_device`, the outer
    prover `tools/outer_prove`, `api`, `utils/jobs`, `aggregation/tree`,
    `parallel/` and `tools/dryrun_multichip` among them) and `chip_smoke.py`
    import with `jax` and the JAX package made unimportable."""
    script = POISON + textwrap.dedent(
        """
        import importlib, pkgutil
        import halo2_aggregation_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        """
    ) + NOTHING_LOADED + 'print("IMPORTED", len(names), " ".join(sorted(names)))\n'
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    imported = res.stdout.split()
    for name in ("ops.msm", "ops.msm_kernels", "plonk.kzg", "plonk.keygen_device", "ops.ec_kernels",
                 "fields", "utils.native", "oracle.pairing", "plonk.prover_native", "aggregation.chips",
                 "models.aggregation_circuit", "convert", "tools.outer_prove", "api", "config",
                 "utils.jobs", "utils.artifacts", "aggregation.tree", "parallel", "parallel.mesh",
                 "parallel.sharded_msm", "parallel.batch_verify", "tools.dryrun_multichip", "bench",
                 "tools.measure"):
        assert "halo2_aggregation_tpu_torch." + name in imported


def test_bench_runs_with_jax_unimportable():
    """`halo2_aggregation_tpu_torch.bench`, every section, on CPU tensors at
    B = 1 and small MSM, NTT and mul-chain sizes, with `jax` and the JAX
    package unimportable: the result line has every gate passed."""
    script = POISON + textwrap.dedent(
        """
        import json
        from halo2_aggregation_tpu_torch import bench
        res = bench.run("cpu", batch=1, trials=1, msm_log2=4, ntt_log2=3, mul_log2=5)
        assert res["value"] > 0 and res["detail"]["gates"] == dict.fromkeys(bench.GATES, True)
        print(json.dumps(res))
        """
    ) + NOTHING_LOADED + 'print("BENCH_OK")\n'
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BENCH_OK" in res.stdout
    assert '"metric": "proofs_aggregated_per_s"' in res.stdout


def test_dryrun_runs_with_jax_unimportable(tmp_path):
    """`tools/dryrun_multichip.py --device cpu --world 2` (two gloo ranks)
    with `jax` and the JAX package unimportable in the caller and in the
    spawned ranks: packages of those names that raise on import come first
    on the path every process starts from."""
    poison = tmp_path / "poison"
    for name in ("jax", "halo2_aggregation_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(f"raise ImportError('{name} is unimportable here')\n")
    env = dict(os.environ, PYTHONPATH=f"{poison}{os.pathsep}{ROOT}", OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "halo2_aggregation_tpu_torch.tools.dryrun_multichip", "--device", "cpu",
         "--world", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip ok" in res.stdout
    assert '"quads_equal_host": true' in res.stdout


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card path does not apply")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    from halo2_aggregation_tpu_torch.plonk.verifier_device import verify_batch

    with pytest.raises(RuntimeError, match="cuda"):
        verify_batch(None, None, [], [], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        verify_batch(None, None, [], [])  # the default device is the card
    from halo2_aggregation_tpu_torch.aggregation.tree import prove_node
    from halo2_aggregation_tpu_torch.tools.outer_prove import run_outer
    from halo2_aggregation_tpu_torch.utils.jobs import aggregate_checkpointed

    with pytest.raises(RuntimeError, match="cuda"):
        aggregate_checkpointed(None, None, [], [], "unused.jsonl")
    with pytest.raises(RuntimeError, match="cuda"):
        prove_node("a", "b")
    with pytest.raises(RuntimeError, match="cuda"):
        run_outer()
    with pytest.raises(RuntimeError, match="cuda"):
        verify_batch(None, None, [], [], fast=False)
    from halo2_aggregation_tpu_torch.parallel.mesh import make_mesh, run_ranks

    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        run_ranks(print, 1)
    from halo2_aggregation_tpu_torch import api

    with pytest.raises(RuntimeError, match="cuda"):
        api.Setup.new(4)
    with pytest.raises(RuntimeError, match="cuda"):
        api.keygen_vk(None, None, None)
    with pytest.raises(RuntimeError, match="cuda"):
        api.keygen_pk(None, None, None)
    with pytest.raises(RuntimeError, match="cuda"):
        api.create_proof(None, None, None, [])


@pytest.mark.parametrize(
    "module, name",
    [
        ("plonk.verifier_device", "verify_batch"),
        ("plonk.prover_device", "create_proof_device"),
        ("plonk.keygen_device", "keygen_device"),
        ("plonk.kzg", "DeviceSRS"),
        ("plonk.quotient_device", "DeviceQuotient"),
        ("api", "verify_batch"),
        ("api", "create_proof"),
        ("api", "keygen_vk"),
        ("api", "keygen_pk"),
        ("api", "Setup.new"),
        ("utils.jobs", "aggregate_checkpointed"),
        ("aggregation.tree", "prove_node"),
        ("tools.outer_prove", "run_outer"),
        ("parallel.mesh", "make_mesh"),
        ("parallel.mesh", "run_ranks"),
        ("bench", "run"),
    ],
)
def test_entry_points_default_to_the_card(module, name):
    """Every entry point runs on the card unless the caller asks for the
    CPU: `device` defaults to "cuda" (which raises where no card is)."""
    import importlib
    import inspect

    fn = importlib.import_module("halo2_aggregation_tpu_torch." + module)
    for part in name.split("."):
        fn = getattr(fn, part)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library(tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").rglob("*.so"))


def test_unknown_device_rejected():
    with pytest.raises(ValueError):
        resolve_device("meta")
