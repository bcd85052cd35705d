"""Operator analyses of the port: the placement advisor.

Copies of pilosa_tpu/analysis/ modules that serve a node (the JAX
package's lint, inventories and lock witness are development tools over
pilosa_tpu/ and are not ported).
"""
