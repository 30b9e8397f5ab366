"""Expression & aggregate function layer (the port's own copy of the JAX
package's `expr/`; reference: `src/expr/`)."""
from .agg import AGG_KINDS, AggCall, AggState, DistinctDedup, create_agg_state
from .expression import Case, Coalesce, Expr, FunctionCall, InputRef, IsNull, Literal
from .functions import build_func, cast

__all__ = [
    "AGG_KINDS", "AggCall", "AggState", "DistinctDedup", "create_agg_state",
    "Case", "Coalesce", "Expr", "FunctionCall", "InputRef", "IsNull", "Literal",
    "build_func", "cast",
]
