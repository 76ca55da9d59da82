"""Config system: YAML + ``_BASE_CONFIG_`` inheritance.

The port's own copy of the reference config surface (``pcdet/config.py``):
``cfg_from_yaml_file(path, cfg)`` loads a yaml into an attribute dict,
honouring a single-level ``_BASE_CONFIG_`` include resolved against the
repository's ``tools/`` directory; ``cfg_from_list`` applies the runners'
``--set KEY VALUE`` pairs.
"""
from ast import literal_eval
from pathlib import Path

import yaml

REPO_ROOT = (Path(__file__).resolve().parent / '..').resolve()


class EasyDict(dict):
    """dict subclass with attribute access, recursively applied."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EasyDict):
            return EasyDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EasyDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EasyDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        del self[k]


def merge_new_config(config, new_config):
    """Recursive merge; handles the ``_BASE_CONFIG_`` include."""
    if '_BASE_CONFIG_' in new_config:
        base_path = Path(new_config['_BASE_CONFIG_'])
        if not base_path.exists():
            # base paths are written relative to tools/
            alt = REPO_ROOT / 'tools' / base_path
            base_path = alt if alt.exists() else base_path
        with open(base_path, 'r') as f:
            config.update(EasyDict(yaml.safe_load(f)))

    for key, val in new_config.items():
        if key == '_BASE_CONFIG_':
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config:
            config[key] = EasyDict()
        merge_new_config(config[key], val)
    return config


def cfg_from_yaml_file(cfg_file, config):
    with open(cfg_file, 'r') as f:
        merge_new_config(config=config, new_config=yaml.safe_load(f))
    return config


def log_config_to_file(cfg_, pre='cfg', logger=None):
    for key, val in cfg_.items():
        if isinstance(val, EasyDict):
            logger.info('----------- %s -----------' % key)
            log_config_to_file(val, pre=pre + '.' + key, logger=logger)
            continue
        logger.info('%s.%s: %s' % (pre, key, val))


def cfg_from_list(cfg_list, config):
    """Set config keys via list (e.g., from command line) with type coercion.

    Values are parsed with ``literal_eval`` when possible and coerced to the
    type of the existing value; missing intermediate keys are created.
    """
    if len(cfg_list) % 2:
        raise ValueError(f'--set takes KEY VALUE pairs, got {cfg_list}')
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split('.')
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                d[subkey] = EasyDict()
            d = d[subkey]
        subkey = key_list[-1]
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v

        if subkey in d and isinstance(d[subkey], type(value)) is False and d[subkey] is not None:
            if isinstance(d[subkey], list) and isinstance(value, str):
                # e.g. --set KEY "a,b,c"
                value = value.split(',')
            elif not isinstance(value, type(d[subkey])):
                try:
                    value = type(d[subkey])(value)
                except (TypeError, ValueError):
                    pass
        d[subkey] = value
