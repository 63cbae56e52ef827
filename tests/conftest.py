import os

# Tests run on a virtual 8-device CPU mesh so multi-device logic is
# exercised without a GPU.  Must be set before jax import.  The
# `gpu`-marked tests run on a GPU host with JAX_PLATFORMS=cuda (README).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xf = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xf:
    os.environ["XLA_FLAGS"] = (xf + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest  # noqa: E402

@pytest.fixture(scope="session")
def drb1_path(tmp_path_factory):
    """A seeded DRB1-shaped pangenome graph (smoothxg_jax.io.synth): 12
    haplotypes, ~163 kbp of path sequence, generated once per session."""
    from smoothxg_jax.io.synth import make_pangenome_gfa
    p = tmp_path_factory.mktemp("drb1") / "drb1_like.gfa"
    make_pangenome_gfa(str(p), seed=0)
    return str(p)


@pytest.fixture(scope="session")
def gpu_devices():
    """The GPUs JAX sees; skips the test when there are none.  Decided
    here, at run time, never while test modules are imported."""
    try:
        return jax.devices("gpu")
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (run the gpu-marked tests with "
                    "JAX_PLATFORMS=cuda on a GPU host)")
