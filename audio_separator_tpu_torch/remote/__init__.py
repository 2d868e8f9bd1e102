"""Remote separation service of the port: the HTTP server and its ASGI
adapter, the job and output stores, the API client and its CLI."""
