"""Offline analysis tooling: the per-device op counter of the dry-run
(`op_stats`) and the roofline over its rows (`roofline`)."""
