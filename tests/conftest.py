import os

# Tests run on JAX's CPU backend unless JAX_PLATFORMS says otherwise (the
# card tests, marked `gpu`, run with JAX_PLATFORMS=cuda).  Multi-device
# tests use a virtual 8-device CPU mesh; both settings must be in place
# before jax initializes.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()

import random

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _seed():
    random.seed(1234)
    np.random.seed(1234)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is an NVIDIA GPU.  Decided
    here, when the test runs, never at import or collection time."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="session")
def synthetic_genomes(tmp_path_factory):
    """4 clusters x 5 mutated copies of a 30 kb seed (simulate-longSequence
    semantics, reference benchmark/simulate)."""
    from tests.helpers import make_clustered_genomes
    tmp = tmp_path_factory.mktemp("genomes")
    return make_clustered_genomes(tmp, n_clusters=4, per_cluster=5,
                                  length=30000, mutation=0.01, seed=7)
