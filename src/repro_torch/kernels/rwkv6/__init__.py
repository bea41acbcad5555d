"""WKV6 recurrence (RWKV-6): ``ops.wkv6`` and its plain version."""
