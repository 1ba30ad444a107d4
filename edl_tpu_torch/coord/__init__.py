"""The coordination-store client and the record types it returns."""
