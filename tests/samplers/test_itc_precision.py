"""The f32 ITC lag products (mixed walker sums and pure per-walker
products) against numpy f64."""
import jax
import pytest

from tests import kernel_reference as kr


@pytest.mark.parametrize("walker_sum", [True, False],
                         ids=["mixed", "pure"])
def test_itc_lag_products_match_f64(walker_sum):
    err = kr.itc_errors(jax.devices("cpu")[0], 512, 16, 8, walker_sum)
    assert err <= kr.ITC_RTOL, err
