"""paddle.incubate: the data generator (ref:
python/paddle/fluid/incubate/data_generator/). The rest of the JAX
package's ``incubate`` waits for ROADMAP Queue 1 items 8, 9 and 12."""
from . import data_generator  # noqa: F401
