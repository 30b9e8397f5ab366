"""SQL lexer + recursive-descent parser (the port's own copy of the JAX
package's `sql/parser.py`).

The `src/sqlparser/` analog (the reference forks sqlparser-rs; this is a
fresh Pratt-style parser over the dialect subset the framework executes).
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from . import ast as A

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<dollar>\$\$.*?\$\$)
  | (?P<param>\$\d+)
  | (?P<qid>"(?:[^"]|"")*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|<=|>=|\|\||::|[-+*/%(),.;=<>\[\]])
""", re.VERBOSE | re.DOTALL)


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: str, pos: int = -1):
        self.kind = kind       # 'num' | 'str' | 'id' | 'kw' | 'op' | 'eof'
        self.value = value
        self.pos = pos         # char offset in the source text

    def __repr__(self):
        return f"{self.kind}:{self.value}"


_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "is", "null", "true", "false",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "create", "table", "source", "materialized", "view", "sink", "index",
    "drop", "insert", "into", "values", "delete", "update", "set", "flush",
    "show", "tables", "sources", "sinks", "views", "primary", "key", "with",
    "case", "when", "then", "else", "end", "cast", "extract", "interval",
    "between", "in", "like", "distinct", "asc", "desc", "exists", "if",
    "over", "partition", "watermark", "for", "append", "only", "explain",
    "tumble", "hop", "emit", "window", "close", "cascade", "rows", "range",
    "unbounded", "preceding", "following", "current", "row", "union", "all",
    "alter",
}


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ValueError(f"cannot tokenize at: {sql[pos:pos+30]!r}")
        start = pos
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "id":
            low = text.lower()
            out.append(Token("kw" if low in _KEYWORDS else "id", low, start))
        elif kind == "qid":
            out.append(Token("id", text[1:-1].replace('""', '"'), start))
        elif kind == "str":
            out.append(Token("str", text[1:-1].replace("''", "'"), start))
        elif kind == "dollar":
            out.append(Token("str", text[2:-2], start))
        elif kind == "param":
            out.append(Token("param", text[1:], start))
        else:
            out.append(Token(kind, text, start))
    out.append(Token("eof", "", len(sql)))
    return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}
_TYPE_NAMES = {
    "int", "integer", "int4", "bigint", "int8", "smallint", "int2",
    "real", "float4", "double", "float8", "float", "numeric", "decimal",
    "boolean", "bool", "varchar", "text", "string", "character",
    "date", "time", "timestamp", "timestamptz", "interval", "bytea",
    "serial",
}


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0
        # CTE scope for the query being parsed: name -> Select | SetOp |
        # A.ChangelogTable; referenced names desugar in _table_factor
        self._ctes: dict = {}

    # ---- token helpers --------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            raise ValueError(
                f"expected {value or kind}, got {self.peek()!r} at {self.i}")
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "kw" and t.value in kws:
            self.next()
            return t.value
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise ValueError(f"expected {kw.upper()}, got {self.peek()!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind in ("id", "kw"):
            self.next()
            return t.value
        raise ValueError(f"expected identifier, got {t!r}")

    # ---- entry ----------------------------------------------------------
    def parse_statements(self) -> List[Any]:
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.parse_statement())
            while self.accept("op", ";"):
                pass
        return stmts

    def parse_statement(self) -> Any:
        t = self.peek()
        if t.kind == "kw":
            if t.value == "select":
                return self.parse_query()
            if t.value == "create":
                return self.parse_create()
            if t.value == "drop":
                return self.parse_drop()
            if t.value == "insert":
                return self.parse_insert()
            if t.value == "delete":
                return self.parse_delete()
            if t.value == "update":
                return self.parse_update()
            if t.value == "flush":
                self.next()
                return A.Flush()
            if t.value == "show":
                self.next()
                if self.accept_kw("all"):
                    return A.ShowVar(None)
                kind = self.ident()
                if kind == "materialized":
                    self.expect_kw("views")
                    kind = "materialized views"
                if kind in ("tables", "sources", "sinks",
                            "materialized views"):
                    return A.ShowObjects(kind)
                return A.ShowVar(kind)
            if t.value == "set":
                self.next()
                return self._parse_set(system=False)
            if t.value == "explain":
                self.next()
                nxt = self.peek()
                if nxt.kind == "id" and nxt.value == "analyze":
                    # EXPLAIN ANALYZE <mv>: live per-operator stats of a
                    # RUNNING streaming job (no statement re-execution —
                    # the batch path has no runtime worth instrumenting)
                    self.next()
                    return A.ExplainAnalyze(self.ident())
                return A.Explain(self.parse_statement())
            if t.value == "alter":
                return self.parse_alter()
            if t.value == "with":
                return self.parse_query()
        raise ValueError(f"cannot parse statement at {t!r}")

    # ---- DDL ------------------------------------------------------------
    def _parse_set(self, system: bool) -> Any:
        """SET <name> [=|TO] <value>; values are literals or bare idents
        (PG-style, e.g. SET timezone TO utc)."""
        name = self.ident()
        if not self.accept("op", "="):
            if self.peek().kind == "id" and self.peek().value == "to":
                self.next()
        t = self.peek()
        if t.kind == "num":
            self.next()
            v: Any = (float(t.value) if any(c in t.value for c in ".eE")
                      else int(t.value))
        elif t.kind == "str":
            self.next()
            v = t.value
        elif t.kind == "kw" and t.value in ("true", "false"):
            self.next()
            v = t.value == "true"
        else:
            v = self.ident()
        return A.SetVar(name, v, system=system)

    def parse_alter(self) -> Any:
        """ALTER MATERIALIZED VIEW <name> SET PARALLELISM [=|TO] <n> /
        ALTER SYSTEM SET <param> [=|TO] <value>
        (`src/frontend/src/handler/alter_parallelism.rs`,
        `handler/alter_system.rs` analogs)."""
        self.expect_kw("alter")
        if self.peek().kind == "id" and self.peek().value == "system":
            self.next()
            self.expect_kw("set")
            return self._parse_set(system=True)
        self.expect_kw("materialized")
        self.expect_kw("view")
        name = self.ident()
        self.expect_kw("set")
        word = self.ident()
        if word != "parallelism":
            raise ValueError(f"ALTER ... SET {word!r} not supported")
        if not self.accept("op", "="):
            if self.peek().kind == "id" and self.peek().value == "to":
                self.next()
        tok = self.expect("num")
        return A.AlterParallelism(name, int(tok.value))

    def parse_create(self) -> Any:
        self.expect_kw("create")
        if self.accept_kw("table"):
            return self._create_table(is_source=False)
        if self.accept_kw("source"):
            return self._create_table(is_source=True)
        if self.accept_kw("materialized"):
            self.expect_kw("view")
            name = self.ident()
            self.expect_kw("as")
            q = self.parse_query()
            self._accept_emit_clause(q)
            return A.CreateMaterializedView(name, q)
        if (self.peek().kind == "id" and self.peek().value == "function") \
                or (self.peek().kind == "kw" and self.peek().value == "or"
                    and self.peek(1).value == "replace"):
            return self._create_function()
        if self.accept_kw("sink"):
            name = self.ident()
            from_name, query = None, None
            if self.accept_kw("from"):
                from_name = self.ident()
            else:
                self.expect_kw("as")
                query = self.parse_query()
            opts = self._with_options()
            return A.CreateSink(name, from_name, query, opts)
        if self.accept_kw("index"):
            name = self.ident()
            self.expect_kw("on")
            table = self.ident()
            self.expect("op", "(")
            cols = [self.ident()]
            while self.accept("op", ","):
                cols.append(self.ident())
            self.expect("op", ")")
            return A.CreateIndex(name, table, cols)
        raise ValueError(f"CREATE what? {self.peek()!r}")

    def _create_function(self) -> A.CreateFunction:
        """CREATE [OR REPLACE] FUNCTION name(t1, t2) RETURNS t
        LANGUAGE python AS $$ ... $$"""
        or_replace = False
        if self.peek().value == "or":
            self.next()
            if self.ident() != "replace":
                raise ValueError("expected REPLACE after CREATE OR")
            or_replace = True
        if self.ident() != "function":
            raise ValueError("CREATE what?")
        name = self.ident()
        arg_types: List[str] = []
        self.expect("op", "(")
        if not (self.peek().kind == "op" and self.peek().value == ")"):
            arg_types.append(self._func_param())
            while self.accept("op", ","):
                arg_types.append(self._func_param())
        self.expect("op", ")")
        word = self.ident()
        if word == "returns":
            ret = self._type_name()
            word = self.ident()
        else:
            raise ValueError("CREATE FUNCTION requires RETURNS <type>")
        if word != "language":
            raise ValueError("CREATE FUNCTION requires LANGUAGE")
        language = self.ident()
        self.expect_kw("as")
        body = self.expect("str").value
        return A.CreateFunction(name, arg_types, ret, language, body,
                                or_replace)

    def _func_param(self) -> str:
        """[pname] type — the optional parameter name is skipped."""
        if self.peek().kind == "id" and self.peek().value not in _TYPE_NAMES \
                and self.peek(1).kind in ("id", "kw") \
                and self.peek(1).value in _TYPE_NAMES:
            self.next()
        return self._type_name()

    def _accept_emit_clause(self, q: A.Select) -> None:
        if self.accept_kw("emit"):
            self.expect_kw("on")
            self.expect_kw("window")
            self.expect_kw("close")
            q.emit_on_window_close = True  # type: ignore[attr-defined]

    def _create_table(self, is_source: bool) -> A.CreateTable:
        name = self.ident()
        columns: List[A.ColumnDef] = []
        pk: List[str] = []
        watermark = None
        if self.accept("op", "("):
            while True:
                if self.accept_kw("primary"):
                    self.expect_kw("key")
                    self.expect("op", "(")
                    pk.append(self.ident())
                    while self.accept("op", ","):
                        pk.append(self.ident())
                    self.expect("op", ")")
                elif self.accept_kw("watermark"):
                    self.expect_kw("for")
                    col = self.ident()
                    self.expect_kw("as")
                    watermark = (col, self.parse_expr())
                else:
                    cname = self.ident()
                    tname = self._type_name()
                    cd = A.ColumnDef(cname, tname)
                    if self.accept_kw("primary"):
                        self.expect_kw("key")
                        cd.primary_key = True
                        pk.append(cname)
                    columns.append(cd)
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        append_only = False
        if self.accept_kw("append"):
            self.expect_kw("only")
            append_only = True
        opts = self._with_options()
        return A.CreateTable(name, columns, pk, opts, append_only, is_source,
                             watermark)

    def _type_name(self) -> str:
        t = self.ident()
        if t == "double":
            self.accept_kw("precision") if False else self.accept("id", "precision")
            return "double"
        if t == "character":
            if self.accept("id", "varying"):
                t = "varchar"
        if t in ("numeric", "decimal", "varchar") and self.accept("op", "("):
            self.next()
            if self.accept("op", ","):
                self.next()
            self.expect("op", ")")
        return t

    def _with_options(self) -> dict:
        opts: dict = {}
        if self.accept_kw("with"):
            self.expect("op", "(")
            while True:
                k = self.ident()
                while self.accept("op", "."):
                    k += "." + self.ident()
                self.expect("op", "=")
                t = self.next()
                opts[k] = t.value
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        return opts

    def parse_drop(self) -> A.DropObject:
        self.expect_kw("drop")
        kind = self.ident()
        if kind == "materialized":
            self.expect_kw("view")
            kind = "materialized view"
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        name = self.ident()
        cascade = bool(self.accept_kw("cascade"))
        return A.DropObject(kind, name, if_exists, cascade)

    # ---- DML ------------------------------------------------------------
    def parse_insert(self) -> A.Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        cols: List[str] = []
        if self.accept("op", "("):
            cols.append(self.ident())
            while self.accept("op", ","):
                cols.append(self.ident())
            self.expect("op", ")")
        if self.accept_kw("values"):
            rows = []
            while True:
                self.expect("op", "(")
                row = [self.parse_expr()]
                while self.accept("op", ","):
                    row.append(self.parse_expr())
                self.expect("op", ")")
                rows.append(row)
                if not self.accept("op", ","):
                    break
            return A.Insert(table, cols, rows)
        q = self.parse_query()
        return A.Insert(table, cols, [], q)

    def parse_delete(self) -> A.Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.ident()
        where = self.parse_expr() if self.accept_kw("where") else None
        return A.Delete(table, where)

    def parse_update(self) -> A.Update:
        self.expect_kw("update")
        table = self.ident()
        self.expect_kw("set")
        assigns = []
        while True:
            c = self.ident()
            self.expect("op", "=")
            assigns.append((c, self.parse_expr()))
            if not self.accept("op", ","):
                break
        where = self.parse_expr() if self.accept_kw("where") else None
        return A.Update(table, assigns, where)

    # ---- SELECT ---------------------------------------------------------
    def parse_query(self) -> A.Query:
        """[WITH ctes] select [UNION [ALL] select]... — the `ast/query.rs`
        Query/SetExpr surface. CTEs include the changelog form
        (`WITH name AS changelog FROM obj`)."""
        saved = self._ctes
        if self.accept_kw("with"):
            self._ctes = dict(saved)
            while True:
                name = self.ident()
                self.expect_kw("as")
                if self.peek().kind == "id" \
                        and self.peek().value == "changelog":
                    self.next()
                    self.expect_kw("from")
                    obj = self.ident()
                    while self.accept("op", "."):   # schema-qualified
                        obj = self.ident()
                    self._ctes[name] = A.ChangelogTable(obj, alias=name)
                else:
                    self.expect("op", "(")
                    self._ctes[name] = self.parse_query()
                    self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        try:
            q: A.Query = self.parse_select()
            while self.accept_kw("union"):
                prev = q.right if isinstance(q, A.SetOp) else q
                if prev.order_by or prev.limit is not None:
                    raise ValueError("ORDER BY/LIMIT before UNION must be "
                                     "parenthesized")
                all_ = bool(self.accept_kw("all"))
                if self.accept_kw("distinct"):
                    all_ = False
                q = A.SetOp("union", all_, q, self.parse_select())
            if isinstance(q, A.SetOp):
                # trailing ORDER BY/LIMIT bind to the whole set operation
                last = q.right
                q.order_by = last.order_by
                q.limit, q.offset = last.limit, last.offset
                last.order_by, last.limit, last.offset = [], None, None
        finally:
            self._ctes = saved
        return q

    def parse_select(self) -> A.Select:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self._table_expr()
        where = self.parse_expr() if self.accept_kw("where") else None
        group_by: List[A.ExprNode] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept("op", ","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.accept_kw("having") else None
        order_by: List[Tuple[A.ExprNode, bool]] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self._order_item())
            while self.accept("op", ","):
                order_by.append(self._order_item())
        limit = offset = None
        if self.accept_kw("limit"):
            limit = int(self.expect("num").value)
        if self.accept_kw("offset"):
            offset = int(self.expect("num").value)
        return A.Select(items, from_, where, group_by, having, order_by,
                        limit, offset, distinct)

    def _select_item(self) -> A.SelectItem:
        if self.accept("op", "*"):
            return A.SelectItem(A.Star())
        # table.* ?
        if (self.peek().kind in ("id",) and self.peek(1).kind == "op"
                and self.peek(1).value == "." and self.peek(2).value == "*"):
            t = self.ident()
            self.next(); self.next()
            return A.SelectItem(A.Star(table=t))
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "id":
            alias = self.ident()
        return A.SelectItem(e, alias)

    def _order_item(self) -> Tuple[A.ExprNode, bool]:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        return (e, desc)

    def _table_expr(self) -> A.TableRef:
        left = self._table_factor()
        while True:
            if self.accept("op", ","):
                right = self._table_factor()
                left = A.Join(left, right, "cross", None)
                continue
            kind = None
            if self.peek().kind == "id" \
                    and self.peek().value.lower() == "asof":
                # ASOF JOIN / ASOF INNER JOIN / ASOF LEFT [OUTER] JOIN
                # (`parser.rs:5012` Keyword::ASOF)
                self.next()
                if self.accept_kw("join"):
                    kind = "asof_inner"
                elif self.accept_kw("inner"):
                    self.expect_kw("join")
                    kind = "asof_inner"
                elif self.accept_kw("left"):
                    self.accept_kw("outer")
                    self.expect_kw("join")
                    kind = "asof_left"
                else:
                    raise ValueError("expected JOIN, INNER JOIN or LEFT "
                                     "JOIN after ASOF")
            elif self.accept_kw("join"):
                kind = "inner"
            elif self.accept_kw("inner"):
                self.expect_kw("join")
                kind = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "full"
            elif self.accept_kw("cross"):
                self.expect_kw("join")
                kind = "cross"
            if kind is None:
                return left
            right = self._table_factor()
            on = None
            if kind != "cross":
                self.expect_kw("on")
                on = self.parse_expr()
            left = A.Join(left, right, kind, on)

    def _table_factor(self) -> A.TableRef:
        if self.accept_kw("tumble") or self.accept_kw("hop"):
            kind = self.toks[self.i - 1].value
            self.expect("op", "(")
            inner = self._table_factor()
            self.expect("op", ",")
            tc = self.ident()
            args = []
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
            alias = self._alias()
            return A.WindowTable(kind, inner, tc, args, alias)
        if self.accept("op", "("):
            if self.peek().kind == "kw" and self.peek().value in ("select",
                                                                  "with"):
                q = self.parse_query()
                self.expect("op", ")")
                return A.SubqueryTable(q, self._alias())
            t = self._table_expr()
            self.expect("op", ")")
            a = self._alias()
            if a:
                t.alias = a
            return t
        name = self.ident()
        if name.lower() in ("generate_series", "unnest") \
                and self.peek().kind == "op" and self.peek().value == "(":
            self.expect("op", "(")
            args = [self.parse_expr()]
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
            return A.TableFunctionTable(name.lower(), args, self._alias())
        # t FOR SYSTEM_TIME AS OF PROCTIME() — temporal join version side
        if self.peek().kind == "kw" and self.peek().value == "for" \
                and self.peek(1).kind == "id" \
                and self.peek(1).value.lower() == "system_time":
            self.next()
            self.next()
            self.expect_kw("as")
            if not (self.peek().kind == "id"
                    and self.peek().value.lower() == "of"):
                raise ValueError("expected OF after FOR SYSTEM_TIME AS")
            self.next()
            fn = self.ident()
            if fn.lower() != "proctime":
                raise ValueError("only FOR SYSTEM_TIME AS OF PROCTIME() "
                                 "is supported")
            self.expect("op", "(")
            self.expect("op", ")")
            return A.TemporalTable(A.NamedTable(name, None), self._alias())
        alias = self._alias()
        cte = self._ctes.get(name)
        if cte is not None:
            if isinstance(cte, A.ChangelogTable):
                return A.ChangelogTable(cte.inner, alias or name)
            return A.SubqueryTable(cte, alias or name)
        return A.NamedTable(name, alias)

    def _alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            return self.ident()
        # ASOF introduces a join (t ASOF JOIN u ...), never an implicit
        # alias — `AS asof` still works
        if self.peek().kind == "id" and self.peek().value.lower() != "asof":
            return self.ident()
        return None

    # ---- expressions (precedence climbing) ------------------------------
    def parse_expr(self) -> A.ExprNode:
        return self._or_expr()

    def _or_expr(self) -> A.ExprNode:
        e = self._and_expr()
        while self.accept_kw("or"):
            e = A.BinOp("or", e, self._and_expr())
        return e

    def _and_expr(self) -> A.ExprNode:
        e = self._not_expr()
        while self.accept_kw("and"):
            e = A.BinOp("and", e, self._not_expr())
        return e

    def _not_expr(self) -> A.ExprNode:
        if self.accept_kw("not"):
            return A.UnaryOp("not", self._not_expr())
        return self._cmp_expr()

    def _cmp_expr(self) -> A.ExprNode:
        e = self._add_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in _CMP_OPS:
                self.next()
                e = A.BinOp(t.value, e, self._add_expr())
                continue
            if t.kind == "kw" and t.value == "is":
                self.next()
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                e = A.IsNullExpr(e, neg)
                continue
            if t.kind == "kw" and t.value in ("between", "in", "like"):
                self.next()
                if t.value == "between":
                    lo = self._add_expr()
                    self.expect_kw("and")
                    hi = self._add_expr()
                    e = A.Between(e, lo, hi, False)
                elif t.value == "in":
                    self.expect("op", "(")
                    if self.peek().kind == "kw" and \
                            self.peek().value == "select":
                        q = self.parse_select()
                        self.expect("op", ")")
                        e = A.InSubquery(e, q, False)
                        continue
                    items = [self.parse_expr()]
                    while self.accept("op", ","):
                        items.append(self.parse_expr())
                    self.expect("op", ")")
                    e = A.InList(e, items, False)
                else:
                    pat = self._add_expr()
                    e = A.FuncCall("like", [e, pat])
                continue
            if t.kind == "kw" and t.value == "not" and \
                    self.peek(1).value in ("between", "in", "like"):
                self.next()
                kw = self.next().value
                if kw == "between":
                    lo = self._add_expr()
                    self.expect_kw("and")
                    hi = self._add_expr()
                    e = A.Between(e, lo, hi, True)
                elif kw == "in":
                    self.expect("op", "(")
                    if self.peek().kind == "kw" and \
                            self.peek().value == "select":
                        q = self.parse_select()
                        self.expect("op", ")")
                        e = A.InSubquery(e, q, True)
                        continue
                    items = [self.parse_expr()]
                    while self.accept("op", ","):
                        items.append(self.parse_expr())
                    self.expect("op", ")")
                    e = A.InList(e, items, True)
                else:
                    pat = self._add_expr()
                    e = A.UnaryOp("not", A.FuncCall("like", [e, pat]))
                continue
            return e

    def _add_expr(self) -> A.ExprNode:
        e = self._mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                op = "concat" if t.value == "||" else t.value
                r = self._mul_expr()
                e = A.FuncCall("concat_op", [e, r]) if op == "concat" \
                    else A.BinOp(op, e, r)
            else:
                return e

    def _mul_expr(self) -> A.ExprNode:
        e = self._unary_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = A.BinOp(t.value, e, self._unary_expr())
            else:
                return e

    def _unary_expr(self) -> A.ExprNode:
        if self.accept("op", "-"):
            return A.UnaryOp("-", self._unary_expr())
        if self.accept("op", "+"):
            return self._unary_expr()
        return self._postfix_expr()

    def _postfix_expr(self) -> A.ExprNode:
        e = self._primary()
        while True:
            if self.accept("op", "::"):
                e = A.CastExpr(e, self._type_name())
            elif self.peek().kind == "op" and self.peek().value == "[":
                self.next()
                idx = int(self.expect("num").value)
                self.expect("op", "]")
                e = A.Index(e, idx)
            else:
                return e

    def _primary(self) -> A.ExprNode:
        t = self.peek()
        if t.kind == "num":
            self.next()
            v = float(t.value) if any(c in t.value for c in ".eE") \
                else int(t.value)
            return A.Lit(v)
        if t.kind == "str":
            self.next()
            return A.Lit(t.value)
        if t.kind == "param":
            self.next()
            return A.Param(int(t.value))
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().kind == "kw" and self.peek().value == "select":
                q = self.parse_select()
                self.expect("op", ")")
                return A.SubqueryExpr(q)
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "kw":
            if t.value == "null":
                self.next()
                return A.Lit(None)
            if t.value in ("true", "false"):
                self.next()
                return A.Lit(t.value == "true")
            if t.value == "interval":
                self.next()
                s = self.expect("str").value
                unit = None
                if self.peek().kind == "id":
                    unit = self.ident()
                return A.Lit(s + (" " + unit if unit else ""), "interval")
            if t.value == "case":
                return self._case()
            if t.value == "cast":
                self.next()
                self.expect("op", "(")
                e = self.parse_expr()
                self.expect_kw("as")
                ty = self._type_name()
                self.expect("op", ")")
                return A.CastExpr(e, ty)
            if t.value == "extract":
                self.next()
                self.expect("op", "(")
                fld = self.ident()
                self.expect_kw("from")
                e = self.parse_expr()
                self.expect("op", ")")
                return A.ExtractExpr(fld, e)
            if t.value == "exists":
                raise ValueError("EXISTS subqueries not supported yet")
            if t.value == "distinct":
                raise ValueError("misplaced DISTINCT")
        if t.kind == "id" \
                and t.value.lower() in ("date", "timestamp", "timestamptz",
                                        "time") \
                and self.peek(1).kind == "str":
            # typed string literal: DATE '2024-01-01' == CAST(.. AS DATE)
            ty = t.value.lower()
            self.next()
            s = self.expect("str").value
            return A.CastExpr(A.Lit(s), ty)
        if t.kind == "id" and t.value.lower() == "array" \
                and self.peek(1).kind == "op" and self.peek(1).value == "[":
            self.next()
            self.next()
            items = []
            if not (self.peek().kind == "op" and self.peek().value == "]"):
                items.append(self.parse_expr())
                while self.accept("op", ","):
                    items.append(self.parse_expr())
            self.expect("op", "]")
            return A.ArrayLit(items)
        # identifier: column, qualified column, or function call
        name = self.ident()
        if self.accept("op", "("):
            distinct = bool(self.accept_kw("distinct"))
            args: List[A.ExprNode] = []
            if self.accept("op", "*"):
                pass  # count(*)
            elif not (self.peek().kind == "op" and self.peek().value == ")"):
                args.append(self.parse_expr())
                while self.accept("op", ","):
                    args.append(self.parse_expr())
            self.expect("op", ")")
            within = None
            if self.peek().kind == "id" and self.peek().value == "within" \
                    and self.peek(1).kind == "kw" \
                    and self.peek(1).value == "group":
                self.next()
                self.next()
                self.expect("op", "(")
                self.expect_kw("order")
                self.expect_kw("by")
                within = self.parse_expr()
                self.expect("op", ")")
            filt = None
            if self.peek().kind == "id" and self.peek().value == "filter" \
                    and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                self.next()
                self.expect("op", "(")
                self.expect_kw("where")
                filt = self.parse_expr()
                self.expect("op", ")")
            over = None
            if self.accept_kw("over"):
                over = self._window_spec()
            return A.FuncCall(name, args, distinct, over, filt,
                              within_group=within)
        if self.accept("op", "."):
            col = self.ident()
            return A.Col(col, table=name)
        return A.Col(name)

    def _window_spec(self) -> A.WindowSpec:
        self.expect("op", "(")
        partition: List[A.ExprNode] = []
        order: List[Tuple[A.ExprNode, bool]] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept("op", ","):
                partition.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self._order_item())
            while self.accept("op", ","):
                order.append(self._order_item())
        frame = None
        if self.accept_kw("rows") or self.accept_kw("range"):
            mode = self.toks[self.i - 1].value
            if self.accept_kw("between"):
                start = self._frame_bound()
                self.expect_kw("and")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = ("current",)
            frame = (mode, start, end)
        self.expect("op", ")")
        return A.WindowSpec(partition, order, frame)

    def _frame_bound(self) -> Tuple:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return ("unbounded", "preceding")
            if self.accept_kw("following"):
                return ("unbounded", "following")
            raise ValueError("expected PRECEDING or FOLLOWING after "
                             "UNBOUNDED")
        if self.accept_kw("current"):
            self.expect_kw("row")
            return ("current",)
        e = self.parse_expr()
        if self.accept_kw("preceding"):
            return ("preceding", e)
        if self.accept_kw("following"):
            return ("following", e)
        raise ValueError("expected PRECEDING or FOLLOWING in frame bound")

    def _case(self) -> A.CaseExpr:
        self.expect_kw("case")
        operand = None
        if not (self.peek().kind == "kw" and self.peek().value == "when"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            branches.append((cond, self.parse_expr()))
        else_expr = self.parse_expr() if self.accept_kw("else") else None
        self.expect_kw("end")
        return A.CaseExpr(operand, branches, else_expr)


def parse_sql(sql: str) -> List[Any]:
    return Parser(sql).parse_statements()


def parse_sql_with_text(sql: str) -> List[tuple]:
    """[(stmt, source_text)] — source slices let DDL be logged verbatim."""
    p = Parser(sql)
    out = []
    while p.peek().kind != "eof":
        start = p.peek().pos
        stmt = p.parse_statement()
        end = p.peek().pos if p.peek().kind != "eof" else len(sql)
        while p.accept("op", ";"):
            end = p.peek().pos if p.peek().kind != "eof" else len(sql)
        out.append((stmt, sql[start:end].rstrip().rstrip(";")))
    return out
