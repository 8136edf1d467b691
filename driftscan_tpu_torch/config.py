"""Declarative typed configuration (equivalent of ``caput.config``).

Classes derive from :class:`Reader` and declare typed class attributes with
:class:`Property`.  Calling ``cls.from_config(cfgdict, *args, **kwargs)``
instantiates the class and populates every declared property from the
matching keys of the dictionary (usually parsed from a YAML section).

This mirrors the configuration model the reference uses throughout
(e.g. driftscan's drift/core/telescope.py:211-243), but is a fresh
implementation.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class CaputConfigError(ValueError):
    """Raised when a config value cannot be interpreted."""


class Property:
    """A declarative typed attribute populated from a config dictionary.

    Parameters
    ----------
    default
        Value (or callable returning a value) used when the config does not
        set the key.  The default is *not* passed through ``proptype``.
    proptype
        Callable used to coerce the raw config value.  ``None`` means
        identity.
    key
        Alternative name of the key in the config dictionary.  By default
        the attribute name is used.
    """

    def __init__(
        self,
        default: Any = None,
        proptype: Optional[Callable] = None,
        key: Optional[str] = None,
    ):
        self.default = default
        self.proptype = (lambda x: x) if proptype is None else proptype
        self.key = key
        self.propname: Optional[str] = None

    def __set_name__(self, owner, name):
        self.propname = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.propname not in obj.__dict__:
            default = self.default() if callable(self.default) else self.default
            obj.__dict__[self.propname] = default
        return obj.__dict__[self.propname]

    def __set__(self, obj, value):
        obj.__dict__[self.propname] = value

    def _from_config(self, obj, config: dict):
        key = self.key if self.key is not None else self.propname
        if key in config:
            raw = config[key]
            try:
                val = self.proptype(raw)
            except Exception as e:  # noqa: BLE001 - surface config errors
                raise CaputConfigError(
                    f"Could not coerce config key '{key}' value {raw!r} "
                    f"for property '{self.propname}': {e}"
                ) from e
            obj.__dict__[self.propname] = val


def float_or_none(value):
    return None if value is None else float(value)


def enum(options, default=None):
    """A property restricted to a fixed set of options."""

    if default is not None and default not in options:
        raise CaputConfigError(f"enum default {default!r} not in options {options!r}")

    def _check(value):
        if value not in options:
            raise CaputConfigError(f"value {value!r} not one of {options!r}")
        return value

    return Property(proptype=_check, default=default)


class Reader:
    """Base class whose :class:`Property` attributes load from a dict."""

    @classmethod
    def from_config(cls, config: Optional[dict], *args, **kwargs):
        """Instantiate the class and populate properties from `config`."""
        self = cls(*args, **kwargs)
        self.read_config(config)
        return self

    def read_config(self, config: Optional[dict]):
        """Populate declared properties from a config dictionary."""
        if config is None:
            config = {}
        if not isinstance(config, dict):
            raise CaputConfigError(f"config must be a dict, got {type(config)}")

        # Walk the full MRO so properties on base classes are honoured.
        for cls in type(self).__mro__:
            for attr in cls.__dict__.values():
                if isinstance(attr, Property):
                    attr._from_config(self, config)

        self._finalise_config()

    def _finalise_config(self):
        """Hook called after configuration has been read."""
