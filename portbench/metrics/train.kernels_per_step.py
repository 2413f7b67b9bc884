from portbench.readers import per_unit_ops as read  # noqa: F401
