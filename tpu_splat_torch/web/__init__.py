"""Local web console + in-browser splat viewer (the port of tpu_splat/web):
a stdlib HTTP server that submits job JSONs to the port's CLI, polls the
JobStore, and renders finished splats in a WebGL2 viewer."""
