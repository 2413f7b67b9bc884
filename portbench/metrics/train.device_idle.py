from portbench.readers import device_idle as read  # noqa: F401
