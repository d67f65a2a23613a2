"""``test_torch_serve.py``'s parity cases on qwen1.5-0.5b (QKV bias,
RMSNorm, tied embeddings), in a file of their own so each file stays
near a minute under the suite's per-file scheduling."""
import pytest

pytest.importorskip("torch")

from test_torch_serve import (  # noqa: E402,F401  (collected here with this file's arch)
    make_arch, test_greedy_tokens_match_reference, test_greedy_tokens_match_reference_flash,
)


@pytest.fixture(scope="module")
def arch():
    return make_arch("qwen1.5-0.5b")
