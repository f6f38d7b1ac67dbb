"""One torch thread for each port test module, and the count back after it.

The port's CPU tests run many small tensor operations (the kernels' plain
versions, the emulations of their bodies).  Under pytest-xdist several
worker processes share the machine's cores, and torch's default intra-op
pool, a thread a core in every worker, then oversubscribes them: each small
operation waits on threads that wait for a core.  Every port test module
imports ``one_torch_thread`` (autouse, module scope): torch runs on one
thread while the module's tests run and gets its former count back after
them, so nothing outside the module (the JAX package's tests in the same
worker) sees the change.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    count = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(count)


def test_a_port_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
