"""Distribution of the port: single-device stand-ins for now
(``sharding``); the mesh comes with a later slice."""
