"""The MIMD quadrant of the port: query routing across replicas."""
from repro_torch.core.mimd.router import POLICIES, Instance, ServiceRouter

__all__ = ["POLICIES", "Instance", "ServiceRouter"]
