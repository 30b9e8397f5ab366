"""sqllogictest runner.

The reference's e2e tier runs `.slt` files against a live cluster
(`docs/dev/src/tests/intro.md:43-75`, `e2e_test/`); this runner executes the
same format against an in-process `Database` (the port's: its device
path on the card unless the Database was given `torch_device="cpu"`). Supported directives:

    statement ok          statement error [substring]
    query <types> [rowsort]   ...SQL...   ----   expected rows
    include <path>        halt          sleep (ignored)

Values compare as canonical strings (ints un-decorated, floats rounded to
3 decimals like sqllogictest, NULL spelled NULL).
"""
from __future__ import annotations

import os
from decimal import Decimal
from typing import List, Optional

from ..sql import Database


class SltError(AssertionError):
    pass


def _canon(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".") if v % 1 else str(int(v))
    if isinstance(v, Decimal):
        return _canon(float(v)) if v % 1 else str(int(v))
    return str(v)


def _rows_to_lines(rows: List[tuple]) -> List[str]:
    return ["\t".join(_canon(v) for v in r) for r in rows]


def run_slt_text(text: str, db: Optional[Database] = None,
                 path: str = "<string>") -> Database:
    db = db or Database()
    lines = text.splitlines()
    i = 0

    def take_sql() -> str:
        nonlocal i
        sql_lines = []
        while i < len(lines) and lines[i].strip() not in ("", "----"):
            sql_lines.append(lines[i])
            i += 1
        return "\n".join(sql_lines)

    while i < len(lines):
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        parts = line.split()
        directive = parts[0]
        if directive == "halt":
            break
        if directive == "sleep":
            i += 1
            continue
        if directive == "include":
            base = os.path.dirname(path)
            with open(os.path.join(base, parts[1])) as f:
                run_slt_text(f.read(), db, parts[1])
            i += 1
            continue
        if directive == "statement":
            expect_err = parts[1] == "error"
            err_sub = " ".join(parts[2:]) if len(parts) > 2 else None
            i += 1
            sql = take_sql()
            try:
                db.run(sql)
                if expect_err:
                    raise SltError(f"{path}: expected error for: {sql}")
            except SltError:
                raise
            except Exception as e:
                if not expect_err:
                    raise SltError(f"{path}: statement failed: {sql}\n{e}") \
                        from e
                if err_sub and err_sub.lower() not in str(e).lower():
                    raise SltError(
                        f"{path}: error {e!r} missing {err_sub!r}") from e
            continue
        if directive == "query":
            sort_mode = parts[2] if len(parts) > 2 else "nosort"
            i += 1
            sql = take_sql()
            if i < len(lines) and lines[i].strip() == "----":
                i += 1
            expected = []
            while i < len(lines) and lines[i].strip() != "":
                expected.append(lines[i].rstrip("\n"))
                i += 1
            rows = db.query(sql)
            got = _rows_to_lines(rows)
            exp = [e.replace("    ", "\t") for e in expected]
            if sort_mode == "rowsort":
                got, exp = sorted(got), sorted(exp)
            if got != exp:
                raise SltError(
                    f"{path}: query mismatch for: {sql}\n"
                    f"expected:\n  " + "\n  ".join(exp) +
                    "\ngot:\n  " + "\n  ".join(got))
            continue
        raise SltError(f"{path}: unknown directive {directive!r}")
    return db


def run_slt_file(path: str, db: Optional[Database] = None) -> Database:
    with open(path) as f:
        return run_slt_text(f.read(), db, path)
