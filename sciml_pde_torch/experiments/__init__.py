"""Experiments of the port: measurement scripts run on the card."""
