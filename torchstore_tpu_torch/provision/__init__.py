"""Provisioning ahead of the first sync: the client-local staging pool."""
