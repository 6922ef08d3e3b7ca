"""Continuous-batching serving: scheduler and block pool (host policy),
engine (device side), report (gauge names, Table-I row).  Import the
submodules directly; this package imports nothing."""
