"""Twin of tests/test_disagg.py on the port: the reference's tests, run on
the ``repro_torch`` copies with the port's own seeded micro params (see
tests/torch_twin.py)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from torch_twin import twin_source  # noqa: E402

exec(compile(twin_source("test_disagg.py"), __file__, "exec"))
