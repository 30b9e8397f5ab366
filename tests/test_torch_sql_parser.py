"""The port's SQL lexer and parser (`risingwave_tpu_torch/sql/parser.py`)
against the JAX package's, statement by statement, over a corpus: every
source and materialized-view string of `bench.py`, every statement and
query record of `e2e_test/**/*.slt`, and a list of malformed statements.
The tokens must be equal, and the ASTs class name by class name and
field by field; a malformed statement must raise the same exception
class with the same message in both."""
import ast
import dataclasses
import enum
from pathlib import Path

import pytest

from host_parity import norm
from risingwave_tpu.sql import parser as ref_parser
from risingwave_tpu_torch.sql import parser as port_parser

ROOT = Path(__file__).resolve().parent.parent


def bench_statements():
    """`bench.py`'s `*_SRC` / `*_MV` strings, read from its source (the
    module is not imported), formatted at one size."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name.endswith(("_SRC", "_MV")):
                text = ast.literal_eval(node.value)
                out.append((f"bench.py:{name}",
                            text.format(n=1 << 22, c=16384)))
    return out


def slt_records():
    """(id, sql) of every `statement` and `query` record, read as
    `testing/slt.py` reads them (the SQL runs to a blank line or
    `----`)."""
    out = []
    for path in sorted((ROOT / "e2e_test").rglob("*.slt")):
        lines = path.read_text().splitlines()
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            if line.split()[:1] in (["statement"], ["query"]):
                start = i + 1
                i += 1
                sql = []
                while i < len(lines) and lines[i].strip() not in ("",
                                                                  "----"):
                    sql.append(lines[i])
                    i += 1
                out.append((f"{path.relative_to(ROOT)}:{start}",
                            "\n".join(sql)))
                continue
            i += 1
    return out


MALFORMED = [
    "SELEC 1",
    "SELECT",
    "SELECT * FROM",
    "SELECT a FROM t WHERE",
    "SELECT (a FROM t",
    "SELECT a FROM t GROUP a",
    "SELECT a FROM t ORDER a",
    "SELECT 'unterminated FROM t",
    "SELECT a FROM t LIMIT",
    "SELECT a FROM t JOIN u",
    "SELECT a FROM t JOIN u ON",
    "SELECT a FROM t CROSS u",
    "SELECT EXISTS (SELECT 1)",
    "SELECT sum(a) OVER (ROWS BETWEEN 1 AND CURRENT ROW) FROM t",
    "SELECT CASE WHEN a THEN 1 FROM t",
    "SELECT CAST(a AS) FROM t",
    "SELECT a FROM t ORDER BY a LIMIT 1 UNION SELECT b FROM u",
    "SELECT a FROM t FOR SYSTEM_TIME AS PROCTIME()",
    "SELECT a FROM t FOR SYSTEM_TIME AS OF NOW()",
    "SELECT a # b FROM t",
    "CREATE",
    "CREATE THING x",
    "CREATE OR TABLE t (a INT)",
    "CREATE TABLE t (a INT",
    "CREATE TABLE (a INT)",
    "CREATE TABLE t (a)",
    "CREATE SOURCE s (a INT) WITH (connector=)",
    "CREATE MATERIALIZED VIEW m SELECT 1",
    "CREATE MATERIALIZED VIEW AS SELECT 1",
    "CREATE FUNCTION f(a INT) AS 'x' LANGUAGE python",
    "CREATE FUNCTION f(a INT) RETURNS INT AS 'x'",
    "CREATE SINK k FROM",
    "CREATE INDEX ON t (a)",
    "DROP",
    "DROP TABLE",
    "INSERT t VALUES (1)",
    "INSERT INTO t VALUES (1",
    "INSERT INTO t VALUES",
    "DELETE t",
    "UPDATE t a = 1",
    "UPDATE t SET a",
    "ALTER TABLE t SET x = 1",
    "ALTER MATERIALIZED VIEW m SET COLOR 3",
    "SET",
    "SET x TO",
    "SHOW",
    "EXPLAIN",
    "42",
    ");",
]


def ast_norm(v):
    """An AST as nested tuples: node class names and fields, values by
    `host_parity.norm`."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return ("node", type(v).__name__,
                [(f.name, ast_norm(getattr(v, f.name)))
                 for f in dataclasses.fields(v)])
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [ast_norm(x) for x in v])
    if isinstance(v, dict):
        return ("dict", sorted(((ast_norm(k), ast_norm(x))
                                for k, x in v.items()), key=repr))
    if isinstance(v, enum.Enum):
        return ("enum", type(v).__name__, v.name)
    return norm(v)


def tokens(parser, sql):
    return [(t.kind, t.value, t.pos) for t in parser.tokenize(sql)]


def outcome(parser, sql):
    """(ok, parsed AST + text of each statement) or (error class,
    message)."""
    try:
        parsed = parser.parse_sql_with_text(sql)
    except Exception as e:              # noqa: BLE001 — compared
        return ("error", type(e).__name__, str(e))
    return ("ok", [(ast_norm(s), text) for s, text in parsed])


CORPUS = bench_statements() + slt_records()


def test_corpus_is_whole():
    """The corpus holds what it should: bench's strings and the records
    of all four slt files."""
    ids = [i for i, _ in CORPUS]
    assert sum(i.startswith("bench.py:") for i in ids) >= 4
    assert {Path(i.split(":")[0]).name for i in ids
            if i.endswith(tuple("0123456789")) and ".slt" in i} >= {
        "executors.slt", "round5_features.slt", "nexmark_queries.slt",
        "nexmark_queries2.slt"}
    assert len(CORPUS) > 100


@pytest.mark.parametrize("sql", [pytest.param(s, id=i) for i, s in CORPUS])
def test_statement_parses_the_same(sql):
    assert tokens(port_parser, sql) == tokens(ref_parser, sql)
    ref = outcome(ref_parser, sql)
    assert ref[0] == "ok", ref            # the corpus is well formed
    assert outcome(port_parser, sql) == ref


@pytest.mark.parametrize("sql", MALFORMED)
def test_malformed_statement_fails_the_same(sql):
    ref = outcome(ref_parser, sql)
    assert ref[0] == "error", ref
    assert outcome(port_parser, sql) == ref
