"""The experiment registry under the JAX package's module path.

`putting_dune_torch.experiments.registry` is `putting_dune_torch.registry`
itself, not a copy: registering an experiment through either name changes
the one registry.
"""

import sys

from putting_dune_torch import registry as _registry

sys.modules[__name__] = _registry
