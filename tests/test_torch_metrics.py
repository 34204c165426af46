"""Port's numpy metrics vs the JAX package's scikit-learn ones.

Random logits with tied rows (so ROC-AUC meets tied scores and the argmax
meets tied predictions), for 2 and 3 classes; the five metrics agree to
1e-12, and the top-k accuracy and the composite score are the same.
"""

import numpy as np
import pytest

from murcl_tpu.ops import metrics as jax_metrics
from murcl_tpu_torch.ops import metrics


@pytest.mark.parametrize("num_class", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_metrics_matches_sklearn(num_class, seed):
    rng = np.random.default_rng(seed)
    n = 40
    logits = rng.normal(size=(n, num_class)).round(1)
    logits[5:10] = logits[0]  # tied scores
    targets = rng.integers(0, num_class, size=n)
    targets[:num_class] = np.arange(num_class)  # every class present
    got = metrics.get_metrics(logits, targets)
    want = jax_metrics.get_metrics(logits, targets)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert metrics.get_score(*got) == pytest.approx(jax_metrics.get_score(*want), abs=1e-12)
    assert metrics.accuracy_topk(logits, targets, (1, 2)) == \
        jax_metrics.accuracy_topk(logits, targets, (1, 2))


def test_binary_auc_needs_both_classes():
    with pytest.raises(ValueError, match="both classes"):
        metrics.get_metrics(np.zeros((4, 2)), np.zeros(4))
