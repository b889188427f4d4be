"""KNN substrate and durable-file helpers."""
