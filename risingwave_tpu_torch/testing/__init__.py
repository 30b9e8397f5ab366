"""Test harnesses: sqllogictest runner, deterministic sim helpers."""
from .slt import SltError, run_slt_file, run_slt_text
