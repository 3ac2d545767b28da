"""FLOP accounting: the counts must follow the factored loss' contraction set
from shapes alone (no padding, no device model)."""

from desmo_tpu import configs, flops, library


def test_dictionary_flops_cylinder_by_hand():
    # cylinder: n=3961, m=1001, r=4, P=3 -> T=35, K=47
    fl = flops.dictionary_step_flops(3961, 1001, 4, 3)
    assert fl["K"] == 47 and library.num_poly_terms(4, 3) == 35
    n, m, K = 3961, 1001, 47
    assert fl["useful"] == 2 * (2 * n * m * K + 2 * n * K * K + 2 * K * K * m)


def test_x_contractions_dominate_large_cells():
    # aneurysm: K=27 terms; the two n*m*K X contractions are ~95% of the step
    fl = flops.dictionary_step_flops(27000, 1000, 4, 2)
    assert fl["K"] == 27
    x_part = 2 * 2 * 27000 * 1000 * 27
    assert 0.9 < x_part / fl["useful"] < 1.0


def test_ae_flops_mlp_dominates():
    cfg = configs.get("ae_cylinder")
    fl = flops.step_flops(cfg)
    # encoder first layer alone: 2*n*m*256 x2 (enc+dec) x3 (fwd+bwd)
    first = 3 * 2 * 2 * cfg.n * cfg.m * 256
    assert fl["useful"] > first  # MLP floor
    dictionary = flops.dictionary_step_flops(cfg.n, cfg.m, cfg.r, cfg.poly_order)
    assert fl["useful"] > 10 * dictionary["useful"]


def test_flops_linear_in_rows():
    fl = flops.dictionary_step_flops(1000, 500, 2, 2)
    one, K = fl["useful"], fl["K"]
    two = flops.dictionary_step_flops(2000, 500, 2, 2)["useful"]
    # doubling n doubles every n-sized term; only the K*K*m terms stay fixed
    assert two - 2 * one == -2 * 2 * K * K * 500


def test_all_presets_dispatch():
    for preset in configs.names():
        cfg = configs.get(preset)
        fl = flops.step_flops(cfg)
        assert fl["useful"] > 0
        assert fl["K"] == library.num_poly_terms(cfg.r, cfg.poly_order) + 3 * cfg.r
