"""The coordination-store client, the record types it returns, and leased registration."""
