"""Postgres wire protocol server (reference: `src/utils/pgwire/`).

    PgServer(Database(device=DeviceConfig(...))).start()

serves the port's Database to any protocol-v3 client (psql, psycopg,
JDBC) on `server.host`, `server.port`."""
from .server import PgServer

__all__ = ["PgServer"]
