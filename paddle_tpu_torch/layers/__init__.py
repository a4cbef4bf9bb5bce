"""fluid.layers surface of the port (the functions the serving and
training slices use)."""
from . import nn
from .nn import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import ops
from .ops import *  # noqa: F401,F403
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import metric_op
from .metric_op import *  # noqa: F401,F403

__all__ = nn.__all__ + io.__all__ + tensor.__all__ + ops.__all__ + \
    learning_rate_scheduler.__all__ + metric_op.__all__
