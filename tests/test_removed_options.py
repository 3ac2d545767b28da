"""Options of the removed hand-written kernels are refused by name, not
ignored."""

import dataclasses

import pytest

from desmo_tpu import configs
from desmo_tpu.models import autoencoder, desmo, fourier


@pytest.mark.parametrize("value", ["fused", "auto"])
def test_removed_loss_method_values_raise(value):
    with pytest.raises(ValueError, match=value):
        dataclasses.replace(configs.get("cylinder"), loss_method=value)


@pytest.mark.parametrize("field", ["chunk_method", "ga_single_pass"])
def test_removed_config_fields_raise(field):
    value = True if field == "ga_single_pass" else "megakernel"
    with pytest.raises(TypeError, match=field):
        dataclasses.replace(configs.get("cylinder"), **{field: value})


@pytest.mark.parametrize(
    "build",
    [
        lambda: desmo.build_loss(desmo.DesmoSpec(8, 4, 2, 2), 1e-3, 1e-4, method="fused"),
        lambda: fourier.build_loss(
            fourier.FourierSpec(8, 4, 2, 2, 1.0, 2, 4.0), 1e-3, 1e-4, method="fused"
        ),
        lambda: autoencoder.build_loss(
            autoencoder.AESpec(8, 4, 2, 2), 1e-3, 1e-4, 1e-3, method="fused"
        ),
    ],
    ids=["desmo", "fourier", "ae"],
)
def test_models_refuse_fused_loss(build):
    with pytest.raises(ValueError, match="fused"):
        build()
