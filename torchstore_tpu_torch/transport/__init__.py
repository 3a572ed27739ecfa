"""Transports between clients and storage volumes."""
