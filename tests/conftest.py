import os

# Tests must see exactly ONE CPU device (the 512-device override belongs to
# launch/dryrun.py only). Also keep compilation deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# hypothesis is optional (offline CI images lack it): register the profile
# only when present; property tests gate themselves via hypothesis_compat.
try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:
    pass
else:
    settings.register_profile(
        "repro", deadline=None, max_examples=30,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large])
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
