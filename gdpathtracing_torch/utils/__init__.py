"""Frame statistics and debug views."""
