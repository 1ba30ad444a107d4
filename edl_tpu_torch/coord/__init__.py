"""The coordination-store client, the record types it returns, leased
registration, and an in-process store (``memory.py``)."""
