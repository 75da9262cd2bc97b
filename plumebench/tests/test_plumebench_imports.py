"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program."""

import os
import subprocess
import sys

from plumebench import imports

REPO = os.path.dirname(os.path.dirname(imports.REFERENCE))


def test_forbidden_names_compare_whole_top_levels():
    loaded = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "optax",
              "tpu_plume", "tpu_plume.core", "tpu_plume_torch",
              "tpu_plume_torch.ops", "jaxtyping", "optaxx", "numpy"]
    assert imports.forbidden_loaded(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "optax", "tpu_plume",
         "tpu_plume.core"])


def test_reference_sources_import_no_program():
    assert imports.reference_faults() == []
    found = imports.reference_imports()
    assert {"train.py", "env.py", "policy_mlp.py", "policy_lstm.py",
            "layers.py", "prng.py"} <= set(found)


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import plumebench.reference.train, plumebench.reference.env\n"
        "import plumebench.reference.field_isotropic\n"
        "import plumebench.reference.field_bank\n"
        "import plumebench.reference.policy_mlp\n"
        "import plumebench.reference.policy_lstm\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    tops = eval(out.strip().splitlines()[-1])
    assert "tpu_plume_torch" not in tops
    assert not set(tops) & imports.FORBIDDEN


def test_a_run_loads_no_jax():
    out = _python(
        "from plumebench import rehearse, imports\n"
        "rehearse.main(['--workload', 'wrf_les_3d.train.n32768', '--envs',"
        " '16', '--unroll', '4', '--seconds', '0.1', '--trace', '1'])\n"
        "print('FOUND', imports.forbidden_loaded())\n")
    assert out.strip().splitlines()[-1] == "FOUND []"
