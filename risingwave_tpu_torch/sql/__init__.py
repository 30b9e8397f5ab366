"""SQL frontend: lexer/parser -> AST -> binder -> stream/batch plans (the
port's own copy of the JAX package's `sql/`).

Re-design of the reference's L9 frontend (`src/frontend/`, `src/sqlparser/`)
scoped to the streaming-SQL core: DDL (tables, sources, MVs, sinks), DML
(insert/delete), and SELECT with joins, aggregation, windows (TUMBLE/HOP),
over-window functions, ORDER BY/LIMIT — the shapes the Nexmark suite uses.
The optimizer is deliberately minimal (the reference's 100+ rule framework
exists to canonicalize what this planner emits directly); plans lower
straight onto the executor layer (`risingwave_tpu_torch/ops/`).
"""
from .catalog import Catalog, CatalogObject
from .database import Database
from .parser import parse_sql
