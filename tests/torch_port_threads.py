"""The port's test modules take one intra-op thread by importing this
module's fixture: ``from torch_port_threads import _one_torch_thread  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's tests and its module-scoped
    fixtures: beside the other test workers an OpenMP team of every core
    waits at each of the many small ops, several times the work's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
