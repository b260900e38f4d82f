"""Retrieval service, socket server and client, evaluation."""
