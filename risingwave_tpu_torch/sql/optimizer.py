"""Logical query optimizer: rewrite rules over the bound-free AST (the
port's own copy of the JAX package's `sql/optimizer.py`).

Analog of `src/frontend/src/optimizer/` scoped to the rules that matter
for this runtime's direct AST->executor lowering (the reference runs
100+ rules over a logical plan IR; here the AST IS the logical plan —
one shape per query — so rules rewrite `Select` trees before lowering):

* constant folding (`const_eval_rewriter.rs` analog): literal arithmetic
  / comparisons / boolean algebra collapse, `WHERE TRUE` drops,
  `WHERE FALSE` stays (planner emits the empty-filter form);
* predicate pushdown (`predicate_push_down.rs` analog): WHERE conjuncts
  over a subquery-in-FROM move inside the subquery (below its
  aggregation when they only touch group-by columns — filtering before
  the agg shrinks device state); pushdown through joins moves
  side-local conjuncts into the relevant subquery side;
* projection pruning happens structurally at lowering (the planner only
  materializes referenced columns into operator payloads).

Every applied rule is recorded; `EXPLAIN` surfaces the list.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

from . import ast as A

_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def fold_expr(e: Any, log: List[str]) -> Any:
    """Bottom-up constant folding over the generic expression walker
    (`planner._clone_with` — it knows every node's children, including
    CASE branch tuples). Division is left alone (type/zero semantics
    belong to the expression layer)."""
    from .planner import _clone_with
    if not isinstance(e, A.ExprNode):
        return e
    e = _clone_with(e, lambda c: fold_expr(c, log))
    if isinstance(e, A.BinOp):
        left, right = e.left, e.right
        if isinstance(left, A.Lit) and isinstance(right, A.Lit) \
                and e.op in _ARITH and left.value is not None \
                and right.value is not None \
                and not isinstance(left.value, str) \
                and not isinstance(right.value, str) \
                and left.type_hint is None and right.type_hint is None:
            try:
                v = _ARITH[e.op](left.value, right.value)
            except Exception:  # noqa: BLE001 — leave unfoldable alone
                return e
            log.append(f"const_fold({left.value} {e.op} {right.value})")
            return A.Lit(v)
        if e.op in ("and", "or"):
            for a, b in ((left, right), (right, left)):
                if isinstance(a, A.Lit) and isinstance(a.value, bool):
                    log.append(f"bool_short_circuit({e.op})")
                    if e.op == "and":
                        return b if a.value else A.Lit(False)
                    return A.Lit(True) if a.value else b
    elif isinstance(e, A.UnaryOp):
        if e.op == "not" and isinstance(e.operand, A.Lit) \
                and isinstance(e.operand.value, bool):
            log.append("const_fold(not)")
            return A.Lit(not e.operand.value)
    return e


def _conjuncts(e: Optional[Any]) -> List[Any]:
    if e is None:
        return []
    if isinstance(e, A.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _conjoin(parts: List[Any]) -> Optional[Any]:
    out = None
    for p in parts:
        out = p if out is None else A.BinOp("and", out, p)
    return out


def _col_tables(e: Any, out: set) -> bool:
    """Collect table qualifiers of every Col; False if any Col is
    unqualified (can't attribute it safely) or a subquery lurks."""
    from .planner import _children
    if isinstance(e, A.Col):
        if e.table is None:
            return False
        out.add(e.table)
        return True
    if isinstance(e, A.SubqueryExpr):
        return False
    ok = True
    for c in _children(e):
        ok = _col_tables(c, out) and ok
    return ok


def _subquery_output(q: A.Select) -> Optional[Dict[str, Any]]:
    """alias -> defining expression for the subquery's select items;
    None when the output shape is unknowable (stars)."""
    out: Dict[str, Any] = {}
    for it in q.items:
        if isinstance(it.expr, A.Star):
            return None
        name = it.alias or (it.expr.name if isinstance(it.expr, A.Col)
                            else None)
        if name is None:
            continue
        out[name] = it.expr
    return out


def _substitute(e: Any, mapping: Dict[str, Any]) -> Any:
    from .planner import _clone_with
    if isinstance(e, A.Col):
        return mapping[e.name]
    if not isinstance(e, A.ExprNode):
        return e
    return _clone_with(e, lambda c: _substitute(c, mapping))


def _contains_agg(e: Any) -> bool:
    from .planner import _contains_agg as pca
    return pca(e)


def _contains_window(e: Any) -> bool:
    from .planner import _children
    if isinstance(e, A.FuncCall) and e.over is not None:
        return True
    return any(_contains_window(c) for c in _children(e))


def _push_into_subquery(sub: A.SubqueryTable, pred: Any,
                        log: List[str]) -> bool:
    """Move `pred` (conjunct over sub.alias columns only) inside the
    subquery — below its aggregation when every referenced column is
    group-by-defined, else into HAVING."""
    q = sub.query
    if q.limit is not None or q.offset:
        return False          # filtering below LIMIT changes the result
    outmap = _subquery_output(q)
    if outmap is None:
        return False
    cols: set = set()

    def names(e, acc):
        from .planner import _children
        if isinstance(e, A.Col):
            acc.add(e.name)
        for c in _children(e):
            names(c, acc)
    names(pred, cols)
    if not cols.issubset(outmap):
        return False
    defs = {c: outmap[c] for c in cols}
    if any(_contains_window(d) for d in defs.values()):
        # window-function outputs: filtering before frame evaluation
        # changes the frames (and OVER can't run in WHERE/HAVING)
        return False
    if any(_contains_agg(d) for d in defs.values()):
        if q.group_by or any(_contains_agg(i.expr) for i in q.items):
            # references an aggregate output: becomes a HAVING conjunct
            inner = _substitute(_strip_qualifiers(pred), defs)
            q.having = _conjoin(_conjuncts(q.having) + [inner])
            log.append("push_predicate_to_having")
            return True
        return False
    inner = _substitute(_strip_qualifiers(pred), defs)
    q.where = _conjoin(_conjuncts(q.where) + [inner])
    log.append("push_predicate_below_agg" if q.group_by
               else "push_predicate_into_subquery")
    return True


def _strip_qualifiers(e: Any) -> Any:
    from .planner import _clone_with
    if isinstance(e, A.Col):
        return A.Col(e.name, None)
    if not isinstance(e, A.ExprNode):
        return e
    return _clone_with(e, _strip_qualifiers)


def _aliased_subqueries(t: Optional[A.TableRef],
                        out: Dict[str, A.SubqueryTable],
                        nullable: bool = False) -> None:
    """Collect alias -> subquery for sides a WHERE conjunct may legally
    move into. A nullable outer-join side is excluded: filtering it
    pre-join would turn matched-then-filtered rows into NULL extensions
    instead of removing them."""
    if isinstance(t, A.SubqueryTable) and t.alias and not nullable:
        out[t.alias] = t
    if isinstance(t, A.Join):
        left_nullable = nullable or t.kind in ("right", "full")
        right_nullable = nullable or t.kind in ("left", "full")
        _aliased_subqueries(t.left, out, left_nullable)
        _aliased_subqueries(t.right, out, right_nullable)


# ---------------------------------------------------------------------------
# rule framework (`src/frontend/src/optimizer/` OptimizationStage analog:
# named rules applied to fixpoint in ordered passes, every application
# logged for EXPLAIN; cost input = catalog row counts via RuleContext)
# ---------------------------------------------------------------------------


class RuleContext:
    def __init__(self, log: List[str], stats=None):
        self.log = log
        self._stats = stats

    def rows(self, table: Optional[str]) -> Optional[int]:
        """Current row count of a named relation (None = unknown) — the
        cost model's cardinality source (the reference reads catalog
        statistics the same way)."""
        if self._stats is None or table is None:
            return None
        try:
            return self._stats(table)
        except Exception:  # noqa: BLE001 — stats are advisory
            return None


class Rule:
    """One rewrite: apply() mutates `q` in place and returns True when it
    changed something (the driver iterates to fixpoint)."""
    name = "?"

    def apply(self, q: A.Select, ctx: RuleContext) -> bool:
        raise NotImplementedError


class ConstantFolding(Rule):
    name = "constant_folding"

    def apply(self, q, ctx):
        # change detection via the log: every real fold records a line
        # (fold_expr clones unconditionally, so identity can't be used)
        n0 = len(ctx.log)
        if q.where is not None:
            q.where = fold_expr(q.where, ctx.log)
            if isinstance(q.where, A.Lit) and q.where.value is True:
                q.where = None
                ctx.log.append("drop_where_true")
        if q.having is not None:
            q.having = fold_expr(q.having, ctx.log)
        q.items = [replace(it, expr=fold_expr(it.expr, ctx.log))
                   if isinstance(it.expr, A.ExprNode) else it
                   for it in q.items]
        return len(ctx.log) > n0


class PredicatePushdown(Rule):
    """WHERE conjuncts over one aliased FROM-subquery move inside it
    (below its aggregation when group-key-only) — predicate_push_down.rs
    analog."""
    name = "predicate_pushdown"

    def apply(self, q, ctx):
        subs: Dict[str, A.SubqueryTable] = {}
        _aliased_subqueries(q.from_, subs)
        if not subs or q.where is None:
            return False
        keep: List[Any] = []
        changed = False
        for pred in _conjuncts(q.where):
            tabs: set = set()
            if _col_tables(pred, tabs) and len(tabs) == 1 \
                    and next(iter(tabs)) in subs \
                    and _push_into_subquery(subs[next(iter(tabs))],
                                            pred, ctx.log):
                changed = True
                continue
            keep.append(pred)
        q.where = _conjoin(keep)
        return changed


def _rel_alias(t: Any) -> Optional[str]:
    if isinstance(t, A.NamedTable):
        return t.alias or t.name
    if isinstance(t, A.SubqueryTable):
        return t.alias
    return None


def _rel_name(t: Any) -> Optional[str]:
    return t.name if isinstance(t, A.NamedTable) else None


class JoinReorder(Rule):
    """Greedy cost-based reordering of pure INNER-join chains: flatten
    the tree, then rebuild left-deep starting from the smallest relation
    and repeatedly joining the smallest CONNECTED one (a predicate must
    link it — no cross products introduced). The cost input is current
    catalog row counts; unknown sizes sort last. The reference's
    reorder rule works over its logical join graph the same way
    (`optimizer/rule/`, join ordering)."""
    name = "join_reorder"

    def apply(self, q, ctx):
        t = q.from_
        if not isinstance(t, A.Join) or t.kind != "inner":
            return False
        rels: List[Any] = []
        preds: List[Any] = []

        def flatten(x) -> bool:
            if isinstance(x, A.Join) and x.kind == "inner" \
                    and x.on is not None:
                if not (flatten(x.left) and flatten(x.right)):
                    return False
                preds.extend(_conjuncts(x.on))
                return True
            if isinstance(x, (A.NamedTable, A.SubqueryTable)) \
                    and _rel_alias(x):
                rels.append(x)
                return True
            return False

        if not flatten(t) or len(rels) < 3:
            return False
        # SELECT * follows the join-tree column order — reordering would
        # silently reshape the output schema
        if any(isinstance(it.expr, A.Star) for it in q.items):
            return False
        aliases = [_rel_alias(r) for r in rels]
        if len(set(aliases)) != len(aliases):
            return False
        # predicate -> set of aliases it references
        pinfo = []
        for p in preds:
            tabs: set = set()
            if not _col_tables(p, tabs) or not tabs <= set(aliases):
                return False        # unresolvable column -> keep shape
            equi = (isinstance(p, A.BinOp) and p.op == "="
                    and isinstance(p.left, A.Col)
                    and isinstance(p.right, A.Col) and len(tabs) == 2)
            pinfo.append((p, tabs, equi))
        sizes = {a: ctx.rows(_rel_name(r))
                 for a, r in zip(aliases, rels)}
        if all(v is None for v in sizes.values()):
            return False            # no cost signal: keep the user's order
        big = 1 << 60

        def size(a):
            return sizes[a] if sizes[a] is not None else big

        by_alias = dict(zip(aliases, rels))
        order = [min(aliases, key=size)]
        remaining = [a for a in aliases if a != order[0]]
        placed_preds: List[List[Any]] = []
        used = [False] * len(pinfo)
        while remaining:
            have = set(order)
            # connectivity = an EQUI predicate links the candidate to the
            # placed set; residual conjuncts alone would build a join the
            # planner rejects ("requires at least one equi-condition")
            connected = [a for a in remaining
                         if any(equi and a in tabs and tabs - {a} <= have
                                for p, tabs, equi in pinfo)]
            if not connected:
                return False        # would need a cross product
            nxt = min(connected, key=size)
            order.append(nxt)
            remaining.remove(nxt)
            have.add(nxt)
            batch = []
            for i, (p, tabs, _e) in enumerate(pinfo):
                if not used[i] and tabs <= have:
                    used[i] = True
                    batch.append(p)
            placed_preds.append(batch)
        if order == aliases:
            return False            # already optimal
        tree: Any = by_alias[order[0]]
        for a, batch in zip(order[1:], placed_preds):
            tree = A.Join(tree, by_alias[a], "inner", _conjoin(batch))
        q.from_ = tree
        ctx.log.append(f"join_reorder({'⋈'.join(order)})")
        return True


RULES: List[Rule] = [ConstantFolding(), PredicatePushdown(), JoinReorder()]
_MAX_PASSES = 4


def optimize(q: A.Select, log: Optional[List[str]] = None,
             stats=None) -> A.Select:
    """Run the rule set to fixpoint over `q` (recursively over FROM
    subqueries, inside-out like the reference's stage pipeline)."""
    if log is None:
        log = []
    q.applied_rules = log   # type: ignore[attr-defined]

    def rec_tables(t: Optional[A.TableRef]) -> None:
        if isinstance(t, A.SubqueryTable):
            optimize(t.query, log, stats)
        elif isinstance(t, A.Join):
            rec_tables(t.left)
            rec_tables(t.right)
        elif isinstance(t, A.WindowTable):
            rec_tables(t.inner)
    rec_tables(q.from_)

    ctx = RuleContext(log, stats)
    for _ in range(_MAX_PASSES):
        applied = [r.apply(q, ctx) for r in RULES]   # no short-circuit
        if not any(applied):
            break
    return q
