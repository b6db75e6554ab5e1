import os

# Tests run on the CPU, with a virtual 8-device platform so the sharding
# logic is exercised without hardware, unless JAX_PLATFORMS names another
# platform. Tests that need the GPU carry the `gpu` marker and skip on the
# CPU (see the `gpu` fixture); on the card run
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import pytest

from _panel import fixture_model, fixture_panel


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (tests marked `gpu` request this)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: on the card run "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Let predict(engine="triton") run the fused kernel in Pallas
    interpret mode on the CPU."""
    from hibag_tpu.models import predict
    monkeypatch.setattr(predict, "_INTERPRET", True)


@pytest.fixture(scope="session")
def panel():
    """(HLATypeTable, SNPGenoData) of the seeded fixture panel."""
    return fixture_panel()


@pytest.fixture(scope="session")
def hapmap_geno(panel):
    return panel[1]


@pytest.fixture(scope="session")
def hla_types(panel):
    """The panel's types in the layout of an HLA_Type_Table data frame."""
    hla = panel[0]
    return {"sample.id": hla.sample_id, "A.1": hla.allele1,
            "A.2": hla.allele2}


@pytest.fixture(scope="session")
def model_list(panel):
    """{"A": hlaAttrBagObj dict} of a small model trained on the panel."""
    return {"A": fixture_model(*panel).to_hibag_obj()}
