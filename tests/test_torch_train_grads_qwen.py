"""The port's training loss and gradients against the reference's for
the three archs no other port test runs: qwen2.5-32b, qwen1.5-110b and
qwen3-moe-30b-a3b, reduced (same family, float32), with
``test_torch_train_grads.py``'s bar: loss and aux within 1e-5, every
gradient leaf within 1e-4 of its largest magnitude.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_grads import TOL, _case, _hold_grads, _port_grads  # noqa: E402

ARCHS = ["qwen2.5-32b", "qwen1.5-110b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    c = _case(request.param)
    c["port"] = _port_grads(c)
    return c


def test_loss_and_aux_match_reference(case):
    loss, aux, _ = case["port"]
    assert abs(float(loss) - case["loss"]) < TOL["float32"][0]
    assert abs(float(aux) - case["aux"]) < TOL["float32"][0]
    assert (float(aux) > 0) == (case["cfg"].moe is not None)


def test_every_gradient_leaf_matches_reference(case):
    _hold_grads(case)
    assert all(float(g.abs().max()) > 0 for g in case["port"][2])
