"""The fleet: a router over engine replicas, with KV page migration."""

from ollamamq_tpu_torch.fleet.members import HttpMember, LocalMember
from ollamamq_tpu_torch.fleet.router import FleetRouter

__all__ = ["FleetRouter", "LocalMember", "HttpMember"]
