"""The power<->throughput workload model of the port."""
