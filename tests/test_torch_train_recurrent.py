"""One and two train steps of the port held against the JAX package's
``make_train_step`` on the CPU for the MoE, Mamba and RWKV-6 smoke
configurations, and the microbatched step (``microbatches=2``) against
the reference's scan accumulation on lm100m, moonshot (MoE) and
whisper-base (encoder).  Procedure and tolerances are those of
``tests/test_torch_train_archs.py``; the MoE configurations cover the
capacity overflow (ROADMAP Queue 3, reference fault 3), whose dropped
writes must give the reference's gradients.
"""

import pytest

from test_torch_lm_serving import RECURRENT_MOE
from test_torch_train_archs import steps_match_reference


@pytest.mark.parametrize("arch", RECURRENT_MOE)
def test_train_steps_match_reference(arch):
    steps_match_reference(arch, 1)


@pytest.mark.parametrize("arch", ["lm100m", "moonshot-v1-16b-a3b",
                                  "whisper-base"])
def test_microbatched_steps_match_reference(arch):
    steps_match_reference(arch, 2)
