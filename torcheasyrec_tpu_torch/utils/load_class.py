"""Class registry: a metaclass that registers every subclass by name.

Counterpart of torcheasyrec_tpu/utils/load_class.py
(get_register_class_meta), so configs can name features and models by
their proto message or class name.
"""

from typing import Any, Dict, Type


def _camel_to_snake(name: str) -> str:
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i > 0 and (not name[i - 1].isupper()):
            out.append("_")
        out.append(c.lower())
    return "".join(out)


def get_register_class_meta(class_map: Dict[str, Type[Any]]) -> type:
    """Build a metaclass registering every subclass into ``class_map``."""

    class RegisterABCMeta(type):
        def __new__(mcs, name, bases, attrs):
            newclass = super().__new__(mcs, name, bases, attrs)
            class_map.setdefault(name, newclass)
            class_map.setdefault(_camel_to_snake(name), newclass)

            @classmethod
            def create_class(cls, cls_name: str):
                if cls_name in class_map:
                    return class_map[cls_name]
                raise NotImplementedError(
                    f"{cls_name} is not ported to torcheasyrec_tpu_torch. "
                    f"Available: {sorted(set(class_map))}"
                )

            newclass.create_class = create_class
            return newclass

    return RegisterABCMeta
