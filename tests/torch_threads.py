"""The port's test files share this fixture: import it into a module with
``from torch_threads import one_torch_thread  # noqa: F401``.

One intra-op thread for the port: its small ops run no slower on one, and
the suite's parallel workers would otherwise oversubscribe the cores (a CLI
test on a busy host slowed twentyfold). Module-scoped, so that a module's
own module-scoped fixtures run under it too; the previous count comes back
after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
