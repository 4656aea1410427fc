"""Row 4 of ``examples/glue_comparison_torch.py``'s table (fine-tuning)
against ``examples/glue_comparison.py``'s; the helper, the arguments and
the bounds are ``test_torch_examples_glue.py``'s."""
import jax
import pytest
import torch
from test_torch_examples_glue import check_row


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.mark.parametrize("row", [4], ids=["ft"])
def test_glue_comparison_row_matches_the_reference(row, monkeypatch):
    check_row(row, monkeypatch)
