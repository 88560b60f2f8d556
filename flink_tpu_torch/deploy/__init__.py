"""Deployment descriptors (Y2/Y3): Kubernetes manifests, YARN gating."""
