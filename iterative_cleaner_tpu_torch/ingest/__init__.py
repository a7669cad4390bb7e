"""Host-side staging of cube blocks for the streaming route."""
