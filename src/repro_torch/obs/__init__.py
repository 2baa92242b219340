"""Telemetry of the port: compile-signature accounting. Spans, metrics and
drift hooks are ROADMAP A8."""
