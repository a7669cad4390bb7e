"""Routes for cubes beyond one device's memory."""
