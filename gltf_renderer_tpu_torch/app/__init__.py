"""The app shell: the headless CLI (`cli`) and the browser viewer (`viewer`)."""
