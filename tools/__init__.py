"""Measurement and check scripts run from the repository root."""
