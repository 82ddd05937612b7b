"""Per-arch parity of the port's loss, grads and trainer with the JAX
package, on every token-input smoke arch (every arch but musicgen-large,
whose ``input_mode`` is ``embeddings``).  The helpers and tolerances are
``tests/test_torch_training.py``'s; the cases live here so that each
file runs in under a minute.
"""
import math

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from test_torch_training import (MOMENT_TOL, TOKEN_ARCHS, TOL_LOSS,
                                 _assert_adam_close, _assert_close_of_max,
                                 _five_steps, _loss_and_grads_agree)
from test_torch_training import (  # noqa: F401  (autouse fixtures)
    _one_torch_thread, _reset_flags)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_loss_and_grads_match_reference(arch):
    assert math.isfinite(_loss_and_grads_agree(arch))


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_trainer_matches_reference_five_steps(arch):
    rt, rh, pt, ph, lr_sum = _five_steps(arch, "none")
    assert pt.step == rt.step == 5 and isinstance(pt.step, int)
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in rh], **TOL_LOSS)
    _assert_adam_close(rt.params, pt.params, lr_sum)
    _assert_close_of_max((rt.opt.m, rt.opt.v), (pt.opt.m, pt.opt.v),
                         MOMENT_TOL, MOMENT_TOL)


