"""The port's train step on deepseek-v32-exp-ess-smoke against the
reference on the CPU, fp32, from the reference's own parameters: seq 32
over its top-8, so the DSA mask, the MoE with its load-balance term and
the MTP head (zero gradient, as the indexer behind the boolean mask) are
all on.  The tests are ``test_torch_train_grads.py``'s, run on this
file's fixture (a file of its own keeps each under a minute on the CPU).
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)

import jax
import pytest

from test_torch_archs import _ref_params_f32, ref_params
from test_torch_train_grads import (make_case,  # noqa: F401  (collected)
                                    test_grads_equal_across_remat,
                                    test_loss_and_grads_match_reference,
                                    test_train_step_matches_reference)

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled():
    yield
    ref_params.cache_clear()
    _ref_params_f32.cache_clear()
    jax.clear_caches()


@pytest.fixture(scope="module")
def case():
    return make_case("deepseek-v32-exp-ess-smoke")
