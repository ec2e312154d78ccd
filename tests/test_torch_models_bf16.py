"""The port's LM serving path at the shipped bfloat16 compute dtype against
the JAX package's: `train_logits`, `prefill` (last logits and the bfloat16
cache) and `decode_step` of every ported smoke arch within atol 5e-2
(tolerances, and why the reference is compiled with excess precision off:
tests/test_torch_models.py)."""
import pytest

from test_torch_models import PORTED, hold_arch


@pytest.mark.parametrize("arch", PORTED)
def test_bfloat16_logits_prefill_and_decode_equal_reference(arch):
    hold_arch(arch, "bfloat16")
