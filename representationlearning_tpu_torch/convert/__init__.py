"""Converters between the JAX package's variable trees and the port's state_dicts."""
