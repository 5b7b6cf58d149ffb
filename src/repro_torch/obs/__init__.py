"""In-graph telemetry of the port's rollout engine."""
