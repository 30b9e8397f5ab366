"""Utilities. The port holds the failpoint registry so far (the JAX
package's metrics, overload, trace and profile plumbing is still to port)."""
from .failpoint import (FailpointError, arm, armed, declare, disarm,
                        failpoint, reset)

__all__ = ["FailpointError", "arm", "armed", "declare", "disarm",
           "failpoint", "reset"]
