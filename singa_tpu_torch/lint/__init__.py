"""netlint: static config/graph/sharding validation + the port's source
lint.

Counterpart of ``singa_tpu/lint``; it imports torch, never jax, and
nothing of the JAX package. Two pass families:

1. **Net/config passes** (``net_rules``, ``shape_rules``, ``cost_model``)
   validate parsed job confs without training anything: schema
   spellings with did-you-mean, dangling/cyclic ``srclayers``,
   phase-exclusion breaks, shape/dtype propagation with the forward on
   ``torch.device("meta")``, param sharing, sharding divisibility, the
   serving/fleet/ring/kernel admission mirrors, and the static memory and
   collective cost model.
2. **AST passes** (``ast_rules``) lint the port's Python for its own
   hazards: a jax or singa_tpu import, a host sync inside a body handed
   to ``Graphed``, a device decision at import time in the card tests.

CLI: ``python -m singa_tpu_torch.tools.lint <job.conf | dir> [--cluster
F]``; ``--self`` lints this package's own source. Rule codes and
severities: ``--list-rules``.
"""

from .core import (  # noqa: F401
    Collector,
    Diagnostic,
    ERROR,
    INFO,
    RULES,
    WARNING,
    render_json,
    render_rule_table,
    render_text,
)
from .cost_model import (  # noqa: F401
    CostReport,
    build_cost_model,
    cost_rules,
    render_cost_report,
)
from .net_rules import (  # noqa: F401
    elastic_rules,
    engine_rules,
    lint_cluster_text,
    lint_model_text,
    ring_rules,
    sharding_rules_static,
    wire_rules,
)
from .shape_rules import shape_pass  # noqa: F401
from .ast_rules import lint_python_file, lint_python_tree  # noqa: F401
